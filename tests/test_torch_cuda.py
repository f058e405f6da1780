"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (a CUDA kernel has no CPU mode). The
file imports neither ``jax`` nor ``mxnet_tpu``, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are float32: rtol 1e-5 / atol 1e-6 for ``bn_act`` (rsqrt and
division may differ by an ulp), 1e-6 absolute for probabilities. The
training kernels sum over a channel in another order than ``torch.sum``:
``bn_stats`` holds mean and variance to rtol 1e-5 / atol 1e-6 plus the
float32 cancellation of the anchored variance (``8 * 2**-23 * dmean**2``,
``dmean`` the distance of the batch mean from the anchor); ``bn_act_bwd``
holds ``dx`` to rtol 1e-4 / atol 1e-5 and the channel sums ``dgamma`` and
``dbeta`` to rtol 1e-4 / atol 1e-3 (thousands of terms of order 1);
``softmax_output_bwd`` and ``sgd_mom_multi`` repeat the plain version's
operations in its order and are held to 1e-6 absolute. ``lstm_cell``,
``lstm_cell_bwd`` and ``adam_multi`` repeat them too, but ``expf``,
``tanhf`` and ``sqrtf`` may round differently from torch's own kernels:
rtol 1e-5 / atol 1e-6. The SSD kernels: ``nms`` is held bit for bit (the
same IoU arithmetic and comparisons); ``multibox_decode``'s boxes and
scores to rtol 1e-6 / atol 1e-7 (the softmax's sum runs in another order)
and its class ids exactly wherever the two best probabilities are further
apart than that; ``l2norm_channel`` to rtol 1e-5 / atol 1e-6 times the
scale (the channel sum runs in another order).
"""

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import adam_multi as adam_mod
from mxnet_tpu_torch.kernels import bn_act as bn_mod
from mxnet_tpu_torch.kernels import bn_act_bwd as bwd_mod
from mxnet_tpu_torch.kernels import bn_stats as stats_mod
from mxnet_tpu_torch.kernels import l2norm_channel as l2_mod
from mxnet_tpu_torch.kernels import lstm_cell as lstm_mod
from mxnet_tpu_torch.kernels import multibox_decode as dec_mod
from mxnet_tpu_torch.kernels import nms as nms_mod
from mxnet_tpu_torch.kernels import sgd_mom_multi as sgd_mod
from mxnet_tpu_torch.kernels import softmax_output_bwd as sob_mod
from mxnet_tpu_torch.kernels import softmax_rows as sm_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bn_inputs(shape, device):
    rng = np.random.default_rng(5)
    c = shape[1]
    arrays = [rng.uniform(-2, 2, shape), rng.uniform(-0.3, 0.3, c),
              rng.uniform(0.5, 2.0, c), rng.uniform(0.5, 1.5, c),
              rng.uniform(-0.5, 0.5, c)]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize("shape", [(4, 64, 56, 56), (4, 2048, 7, 7),
                                   (3, 5, 7, 9), (2, 3)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_bn_act_kernel_matches_plain(card, shape, relu, fix_gamma):
    ins = _bn_inputs(shape, card)
    before = bn_mod.LAUNCHES.value
    got = bn_mod.bn_act(*ins, 2e-5, fix_gamma, relu)
    want = bn_mod.bn_act_plain(*ins, 2e-5, fix_gamma, relu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert bn_mod.LAUNCHES.value == before + 1


@pytest.mark.parametrize("shape", [(32, 1000), (1, 1000), (7, 1001)])
def test_softmax_rows_kernel_matches_plain(card, shape):
    x = torch.randn(shape, device=card) * 4
    before = sm_mod.LAUNCHES.value
    got = sm_mod.softmax_rows(x)
    torch.testing.assert_close(got, sm_mod.softmax_rows_plain(x),
                               rtol=0, atol=1e-6)
    assert sm_mod.LAUNCHES.value == before + 1


def test_kernels_raise_on_what_they_do_not_take(card):
    x = torch.randn(2, 3, 4, 4, device=card)
    stats = [torch.ones(3, device=card) for _ in range(4)]
    with pytest.raises(MXNetError):
        bn_mod.bn_act(x.double(), *[s.double() for s in stats], 1e-5,
                      False, True)
    with pytest.raises(MXNetError):
        bn_mod.bn_act(x.transpose(2, 3), *stats, 1e-5, False, True)
    with pytest.raises(MXNetError):
        bn_mod.bn_act(x, *stats[:3], stats[3].cpu(), 1e-5, False, True)
    with pytest.raises(MXNetError):
        sm_mod.softmax_rows(x[:, :, 0, :].transpose(0, 1))
    with pytest.raises(MXNetError):
        sm_mod.softmax_rows(x)


# -- training kernels ---------------------------------------------------------
TRAIN_SHAPES = [(8, 64, 56, 56), (4, 2048, 7, 7), (9, 4, 3, 3), (3, 5, 7, 9),
                (5, 3)]


def _stats_inputs(shape, device, offset):
    rng = np.random.default_rng(7)
    c = shape[1]
    x = rng.standard_normal(shape) * rng.uniform(0.5, 2, (1, c) + (1,) *
                                                (len(shape) - 2)) + offset
    mm = rng.uniform(-0.5, 0.5, c)
    mv = rng.uniform(0.5, 2.0, c)
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (x, mm, mv)]


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("offset", [0.0, 30.0])
def test_bn_stats_kernel_matches_plain(card, shape, offset):
    x, mm, mv = _stats_inputs(shape, card, offset)
    mm2, mv2 = mm.clone(), mv.clone()
    before = stats_mod.LAUNCHES.value
    got = stats_mod.bn_stats(x, mm, mv, 0.9)
    want = stats_mod.bn_stats_plain(x, mm2, mv2, 0.9)
    assert stats_mod.LAUNCHES.value == before + 1
    dmean2 = float((want[0] - mm2).abs().max()) ** 2 + offset ** 2
    cancel = 8 * 2.0 ** -23 * dmean2
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6 + cancel)
    torch.testing.assert_close(mm, mm2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mv, mv2, rtol=1e-5, atol=1e-6 + cancel)
    if not offset:
        assert torch.equal(got[2], want[2])


def _bwd_inputs(shape, device):
    rng = np.random.default_rng(8)
    c = shape[1]
    f = [rng.standard_normal(shape), rng.standard_normal(shape),
         rng.uniform(-0.3, 0.3, c), rng.uniform(0.5, 2.0, c),
         rng.uniform(0.5, 1.5, c), rng.choice([0.0, 0.5, 1.0], c)]
    dy, x, mean, var, gamma, kvar = (
        torch.from_numpy(a.astype(np.float32)).to(device) for a in f)
    y = torch.relu(x - 0.1)
    return dy, y, x, mean, var, gamma, kvar


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("relu, fix_gamma, batch_stats",
                         [(True, False, True), (False, True, True),
                          (True, True, False)])
def test_bn_act_bwd_kernel_matches_plain(card, shape, relu, fix_gamma,
                                         batch_stats):
    dy, y, x, mean, var, gamma, kvar = _bwd_inputs(shape, card)
    kvar = kvar if batch_stats else None
    y = y if relu else None
    before = bwd_mod.LAUNCHES.value
    got = bwd_mod.bn_act_bwd(dy, y, x, mean, var, gamma, kvar, 2e-5,
                             fix_gamma, relu)
    want = bwd_mod.bn_act_bwd_plain(dy, y, x, mean, var, gamma, kvar, 2e-5,
                                    fix_gamma, relu)
    assert bwd_mod.LAUNCHES.value == before + 2
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape, kwargs", [
    ((32, 1000), {}),
    ((32, 1000), {"normalization": "batch", "grad_scale": 0.5}),
    ((7, 11), {"normalization": "valid", "use_ignore": True,
               "ignore_label": 3.0}),
    ((2, 5, 3, 4), {"multi_output": True, "normalization": "valid"}),
    ((2, 3, 7), {"use_ignore": True, "ignore_label": 0.0}),
])
def test_softmax_output_bwd_kernel_matches_plain(card, shape, kwargs):
    rng = np.random.default_rng(9)
    p = torch.softmax(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)), dim=-1).to(card)
    classes = shape[1] if kwargs.get("multi_output") else shape[-1]
    lshape = ((shape[0],) + shape[2:] if kwargs.get("multi_output")
              else shape[:-1])
    label = torch.from_numpy(rng.integers(0, classes, lshape).astype(
        np.float32)).to(card)
    before = sob_mod.LAUNCHES.value
    got = sob_mod.softmax_output_bwd(p, label, **kwargs)
    valid = kwargs.get("normalization") == "valid"  # count kernel + rows
    assert sob_mod.LAUNCHES.value == before + (2 if valid else 1)
    torch.testing.assert_close(
        got, sob_mod.softmax_output_bwd_plain(
            p, label, kwargs.get("grad_scale", 1.0),
            kwargs.get("ignore_label", -1.0), kwargs.get("use_ignore", False),
            kwargs.get("normalization", "null"),
            kwargs.get("multi_output", False)), rtol=0, atol=1e-6)


def _sgd_inputs(device, sizes=(1, 7, 64, 70000, 32769)):
    rng = np.random.default_rng(10)
    make = [lambda n: rng.standard_normal(n) for _ in range(3)]
    return [[torch.from_numpy(m(n).astype(np.float32)).to(device)
             for n in sizes] for m in make]


@pytest.mark.parametrize("momentum, clip", [(0.9, -1.0), (0.9, 0.5),
                                            (0.0, -1.0)])
def test_sgd_mom_multi_kernel_matches_plain(card, momentum, clip):
    ws, gs, ms = _sgd_inputs(card)
    moms = ms if momentum else None
    lrs = [0.1, 0.05, 0.1, 0.2, 0.1]
    wds = [1e-4, 0.0, 1e-4, 1e-4, 0.0]
    ref = [[t.clone() for t in ws], [t.clone() for t in ms]]
    cache = {}
    before = sgd_mod.LAUNCHES.value
    builds = sgd_mod.TABLE_BUILDS.value
    for _ in range(2):
        sgd_mod.sgd_mom_multi(ws, gs, moms, lrs, wds, momentum, 1 / 32, clip,
                              cache=cache)
        sgd_mod.sgd_mom_multi_plain(ref[0], gs, ref[1] if moms else None,
                                    lrs, wds, momentum, 1 / 32, clip)
    assert sgd_mod.LAUNCHES.value == before + 2
    assert sgd_mod.TABLE_BUILDS.value == builds + 1  # cached between steps
    for got, want in zip(ws + (ms if moms else []),
                         ref[0] + (ref[1] if moms else [])):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_sgd_mom_multi_guard_skips_a_non_finite_step(card):
    ws, gs, ms = _sgd_inputs(card)
    aux, snap = torch.ones(50000, device=card), torch.zeros(50000, device=card)
    guard = sgd_mod.Guard(torch.zeros(2, dtype=torch.int32, device=card),
                          [(aux, snap)])
    w0, m0 = [t.clone() for t in ws], [t.clone() for t in ms]
    gs[3][123] = float("nan")
    before = sgd_mod.LAUNCHES.value
    sgd_mod.sgd_mom_multi(ws, gs, ms, [0.1] * 5, [1e-4] * 5, 0.9, 1.0, -1.0,
                          guard=guard)
    assert sgd_mod.LAUNCHES.value == before + 2  # probe + update
    assert guard.counters.tolist() == [1, 1]
    for got, want in zip(ws + ms, w0 + m0):
        assert torch.equal(got, want)
    assert torch.equal(aux, snap)
    gs[3][123] = 0.0
    aux.fill_(2.0)
    sgd_mod.sgd_mom_multi(ws, gs, ms, [0.1] * 5, [1e-4] * 5, 0.9, 1.0, -1.0,
                          guard=guard)
    assert guard.counters.tolist() == [1, 0]
    assert not torch.equal(ws[3], w0[3]) and bool((aux == 2.0).all())


# -- LSTM-PTB kernels ---------------------------------------------------------
LSTM_TOL = dict(rtol=1e-5, atol=1e-6)


def _lstm_inputs(device, n=32, hidden=200):
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal((n, 4 * hidden)) * 2,
              rng.standard_normal((n, 4 * hidden)) * 2,
              rng.standard_normal((n, hidden)),
              rng.standard_normal((n, hidden)),
              rng.standard_normal((n, hidden))]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
@pytest.mark.parametrize("shape", [(32, 200), (3, 5)])
def test_lstm_cell_kernels_match_plain(card, forget_bias, shape):
    i2h, h2h, c, dh, dc = _lstm_inputs(card, *shape)
    before = (lstm_mod.LAUNCHES.value, lstm_mod.BWD_LAUNCHES.value)
    got = lstm_mod.lstm_cell(i2h, h2h, c, forget_bias)
    want = lstm_mod.lstm_cell_plain(i2h, h2h, c, forget_bias)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **LSTM_TOL)
    act, next_c = want[2], want[1]
    for dnext_c in (dc, None):  # None: the last step's next_c
        got_b = lstm_mod.lstm_cell_bwd(dh, dnext_c, act, c, next_c)
        want_b = lstm_mod.lstm_cell_bwd_plain(dh, dnext_c, act, c, next_c)
        for g, w in zip(got_b, want_b):
            torch.testing.assert_close(g, w, **LSTM_TOL)
    assert (lstm_mod.LAUNCHES.value, lstm_mod.BWD_LAUNCHES.value) == (
        before[0] + 1, before[1] + 2)
    _h, _c, none = lstm_mod.lstm_cell(i2h, h2h, c, forget_bias, save=False)
    assert none is None


def test_lstm_cell_kernels_raise_on_what_they_do_not_take(card):
    i2h, h2h, c, dh, _dc = _lstm_inputs(card, 4, 8)
    with pytest.raises(MXNetError):
        lstm_mod.lstm_cell(i2h.double(), h2h.double(), c.double())
    with pytest.raises(MXNetError):
        lstm_mod.lstm_cell(i2h, h2h, c[:, :7])
    with pytest.raises(MXNetError):
        lstm_mod.lstm_cell(i2h, h2h.cpu(), c)
    with pytest.raises(MXNetError):
        lstm_mod.lstm_cell_bwd(dh.t().contiguous().t(), None, i2h, c, c)


def _adam_inputs(device, sizes=(1, 7, 64, 70000, 8193)):
    rng = np.random.default_rng(12)
    ws = [rng.standard_normal(n) * 0.1 for n in sizes]
    gs = [rng.standard_normal(n) for n in sizes]
    ms = [rng.standard_normal(n) * 0.01 for n in sizes]
    vs = [rng.uniform(0, 1e-3, n) for n in sizes]
    return [[torch.from_numpy(a.astype(np.float32)).to(device) for a in arr]
            for arr in (ws, gs, ms, vs)]


@pytest.mark.parametrize("wd, clip", [(0.0, -1.0), (1e-4, 0.5),
                                      (1e-2, -1.0)])
def test_adam_multi_kernel_matches_plain(card, wd, clip):
    ws, gs, ms, vs = _adam_inputs(card)
    lrs = [3e-3, 1e-3, 3e-3, 2e-3, 3e-3]
    wds = [wd, 0.0, wd, wd, 0.0]
    ref = [[t.clone() for t in x] for x in (ws, ms, vs)]
    cache = {}
    before = adam_mod.LAUNCHES.value
    builds = adam_mod.TABLE_BUILDS.value
    for _ in range(2):
        adam_mod.adam_multi(ws, gs, ms, vs, lrs, wds, 0.9, 0.999, 1e-8,
                            1 / 32, clip, cache=cache)
        adam_mod.adam_multi_plain(*ref[:1], gs, *ref[1:], lrs, wds, 0.9,
                                  0.999, 1e-8, 1 / 32, clip)
    assert adam_mod.LAUNCHES.value == before + 2
    assert adam_mod.TABLE_BUILDS.value == builds + 1  # cached between steps
    for got, want in zip(ws + ms + vs, ref[0] + ref[1] + ref[2]):
        torch.testing.assert_close(got, want, **LSTM_TOL)


def test_adam_multi_guard_skips_a_non_finite_step(card):
    ws, gs, ms, vs = _adam_inputs(card)
    aux, snap = torch.ones(9000, device=card), torch.zeros(9000, device=card)
    guard = sgd_mod.Guard(torch.zeros(2, dtype=torch.int32, device=card),
                          [(aux, snap)])
    before = [t.clone() for t in ws + ms + vs]
    gs[3][123] = float("nan")
    n = adam_mod.LAUNCHES.value
    args = ([1e-3] * 5, [1e-4] * 5, 0.9, 0.999, 1e-8, 1.0, -1.0)
    adam_mod.adam_multi(ws, gs, ms, vs, *args, guard=guard)
    assert adam_mod.LAUNCHES.value == n + 2  # probe + update
    assert guard.counters.tolist() == [1, 1]
    for got, want in zip(ws + ms + vs, before):
        assert torch.equal(got, want)
    assert torch.equal(aux, snap)
    gs[3][123] = 0.0
    aux.fill_(2.0)
    adam_mod.adam_multi(ws, gs, ms, vs, *args, guard=guard)
    assert guard.counters.tolist() == [1, 0]
    assert not torch.equal(ws[3], before[3]) and bool((aux == 2.0).all())


def test_bucketing_fit_on_the_card_updates_one_storage(card):
    """A small BucketingModule.fit on the card: every step of bucket T
    launches 2T cell steps each way and one Adam update; every bucket's
    executor builds its Adam table once, over the same weights and
    states."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(1)
    sents = [list(rng.randint(1, 40, n)) for n in [3, 4, 7, 8] * 6]
    it = mx.rnn.BucketSentenceIter(sents, 4, buckets=[4, 8], invalid_label=0)
    sym_gen, states = mx.models.lstm_lm_sym_gen(
        num_hidden=16, num_layers=2, num_embed=16, vocab_size=40)
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 state_names=states)

    def counts():
        return (lstm_mod.LAUNCHES.value, lstm_mod.BWD_LAUNCHES.value,
                adam_mod.LAUNCHES.value)

    steps, last = [], [counts()]

    def on_batch(param):
        now = counts()
        steps.append((param.locals["data_batch"].bucket_key,
                      tuple(a - b for a, b in zip(now, last[0]))))
        last[0] = now

    builds = adam_mod.TABLE_BUILDS.value
    mod.fit(it, eval_metric=mx.metric.Perplexity(0), optimizer="adam",
            optimizer_params={"learning_rate": 0.01}, num_epoch=2,
            batch_end_callback=on_batch)
    assert {b for b, _ in steps} == {4, 8}
    assert all(n == (2 * b, 2 * b, 1) for b, n in steps)
    assert adam_mod.TABLE_BUILDS.value == builds + 2
    keys = {m._exec_group._exec._update_cache["key"]
            for m in mod._buckets.values()}
    assert len(keys) == 1


# -- SSD kernels -------------------------------------------------------------
def _chip_smoke():
    """chip_smoke.py's NMS input generators (the same sets it checks)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(8, 512, 37, 37), (3, 5, 7, 9), (2, 3),
                                   (1, 1000, 1, 1)])
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_l2norm_channel_kernel_matches_plain(card, shape, scale):
    x = torch.randn(shape, device=card)
    before = l2_mod.LAUNCHES.value
    got = l2_mod.l2norm_channel(x, 1e-10, scale)
    torch.testing.assert_close(got, l2_mod.l2norm_channel_plain(
        x, 1e-10, scale), rtol=1e-5, atol=1e-6 * scale)
    assert l2_mod.LAUNCHES.value == before + 1


def _decode_inputs(device, n=3, c1=21, a=1000):
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 1.5, (n, a, c1)).astype(np.float32)
    loc = rng.normal(0, 1, (n, 4 * a)).astype(np.float32)
    lo = rng.uniform(0, 0.8, (1, a, 2))
    anchors = np.concatenate([lo, lo + rng.uniform(0.02, 0.5, (1, a, 2))], 2)
    # the class scores as the SSD head hands them over: a transposed view
    cls = torch.from_numpy(logits).to(device).transpose(1, 2)
    return cls, torch.from_numpy(loc).to(device), \
        torch.from_numpy(anchors.astype(np.float32)).to(device)


@pytest.mark.parametrize("softmax, strided", [(True, True), (True, False),
                                              (False, False)])
@pytest.mark.parametrize("clip", [True, False])
def test_multibox_decode_kernel_matches_plain(card, softmax, strided, clip):
    cls, loc, anchors = _decode_inputs(card)
    if not softmax:
        cls = dec_mod.channel_softmax(cls)
    if not strided:
        cls = cls.contiguous()
    var = (0.1, 0.1, 0.2, 0.2)
    before = dec_mod.LAUNCHES.value
    boxes, score, cls_id = dec_mod.multibox_decode(cls, loc, anchors, var,
                                                   clip, softmax)
    w_boxes, w_score, w_id = dec_mod.multibox_decode_plain(
        cls, loc, anchors, var, clip, softmax)
    assert dec_mod.LAUNCHES.value == before + 1
    torch.testing.assert_close(boxes, w_boxes, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(score, w_score, rtol=1e-6, atol=1e-7)
    fg = (dec_mod.channel_softmax(cls) if softmax else cls)[:, 1:]
    top2 = torch.topk(fg, 2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > 1e-6 * top2[:, 0] + 1e-7
    assert bool((cls_id == w_id)[clear].all()) and cls_id.dtype == torch.int32


@pytest.mark.parametrize("a", [5, 64, 65, 130, 1000])
@pytest.mark.parametrize("nms_threshold, force", [(0.5, False), (0.25, False),
                                                  (0.5, True)])
def test_nms_kernel_matches_plain_bit_for_bit(card, a, nms_threshold, force):
    """Grid boxes with IoUs exactly at the threshold and tied scores."""
    ins = _chip_smoke().nms_grid_inputs(torch, card, seed=a, n=3, a=a)
    before = nms_mod.LAUNCHES.value
    got = nms_mod.nms(*ins, 0.01, nms_threshold, force)
    want = nms_mod.nms_plain(*ins, 0.01, nms_threshold, force)
    assert nms_mod.LAUNCHES.value == before + 2  # mask and scan
    assert torch.equal(got, want)


@pytest.mark.parametrize("nms_threshold, force", [(0.5, False), (0.5, True),
                                                  (0.3, False)])
def test_nms_kernel_on_ties_and_an_invalid_image(card, nms_threshold, force):
    ins = _chip_smoke().nms_tie_inputs(torch, card, seed=3)
    got = nms_mod.nms(*ins, 0.01, nms_threshold, force)
    assert torch.equal(got, nms_mod.nms_plain(*ins, 0.01, nms_threshold,
                                              force))
    assert int((got[2, :, 0] >= 0).sum()) == 0


def test_ssd_kernels_raise_on_what_they_do_not_take(card):
    cls, loc, anchors = _decode_inputs(card)
    var = (0.1, 0.1, 0.2, 0.2)
    with pytest.raises(MXNetError):
        dec_mod.multibox_decode(cls.double(), loc, anchors, var, True, True)
    with pytest.raises(MXNetError):
        dec_mod.multibox_decode(cls, loc[:, 1:], anchors, var, True, True)
    with pytest.raises(MXNetError):
        dec_mod.multibox_decode(cls, loc, anchors.cpu(), var, True, True)
    boxes, score, cls_id = dec_mod.multibox_decode(cls, loc, anchors, var,
                                                   True, True)
    order = torch.argsort(-score, dim=1, stable=True)
    with pytest.raises(MXNetError):
        nms_mod.nms(boxes, score, cls_id.long(), order, 0.01, 0.5, False)
    with pytest.raises(MXNetError):
        nms_mod.nms(boxes, score, cls_id, order.int(), 0.01, 0.5, False)
    with pytest.raises(MXNetError):
        l2_mod.l2norm_channel(torch.randn(2, 3, 4, device=card).transpose(
            1, 2), 1e-10)
