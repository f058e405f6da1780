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
``sgd_mom_multi`` repeats the plain version's operations in its order and
is held to 1e-6 absolute; ``softmax_output_bwd`` does too and is held bit
for bit (``torch.equal``) to the plain version run on the CPU, whose
divisions are correctly rounded as the kernel's are (PyTorch's CUDA
division by a Python number multiplies by the reciprocal), one launch a
call under every normalization, and two streams counting at once keep
their counts apart. ``lstm_cell``,
``lstm_cell_bwd`` and ``adam_multi`` repeat them too, but ``expf``,
``tanhf`` and ``sqrtf`` may round differently from torch's own kernels:
rtol 1e-5 / atol 1e-6. The SSD kernels: ``nms`` is held bit for bit (the
same IoU arithmetic and comparisons); ``multibox_decode``'s boxes and
scores to rtol 1e-6 / atol 1e-7 (the softmax's sum runs in another order)
and its class ids exactly wherever the two best probabilities are further
apart than that; ``l2norm_channel`` to rtol 1e-5 / atol 1e-6 times the
scale (the channel sum runs in another order). The SSD training kernels:
``multibox_target`` is held bit for bit (the same IoU, encoding and
comparisons, and the same mining order); ``l2norm_channel_bwd`` to 1e-5
of the magnitudes of its two terms at each position plus 1e-6 of the
largest value (``bwd_limit``: its sums run in another order, and the two
terms cancel where the gradient lies along the input). The
DCGAN route: ``bn_act`` and ``bn_act_bwd`` with a LeakyReLU slope, at the
discriminator's shapes and on pre-activations exactly +-0 and a constant
channel, to the same tolerances; at slope 0 the kernels' ReLU (+0.0 for
negative values, a zero gradient at 0) exactly. The redesigned kernels:
``softmax_rows`` at each of its regime borders and on views at a float
offset (1e-6 absolute); ``sgd_mom_multi`` bit for bit on sizes no
multiple of 4, on views off the 16-byte alignment, over more tensors than
one launch holds and under the guard; ``adam_multi`` bit for bit under
the guard; ``bn_act_bwd`` on each side of its block and cluster limits,
at planes of 49 and 16 and on views at a float offset, for all three
activations (its tolerances above, launches as planned, two calls bit for
bit); ``lstm_cell``'s outputs as views of one allocation, and the backward
through them; ``nms`` by class segments bit for bit at each border of its
plan (a class of L_max - 1, L_max and L_max + 1 boxes, force and one class
holding all 8096 anchors: the long route, class ids out of range, A = 1
and A not a multiple of 64, a batch whose images take different routes);
``bn_stats`` at each regime border and path shape, aligned and at float
offsets 1 and 3 (its tolerances above, ``kvar`` exactly, launches as
planned, two calls bit for bit); neither wrapper copies to or from the host
or synchronises in a call (``torch.profiler``). The redesigned
``l2norm_channel_bwd`` at its edge shapes (C = 1, H*W = 1, rank 2, blocks
straddling two images, each side of the two-pass border) within
``bwd_limit``, as planned, one launch a call, two calls bit for bit; the
redesigned ``softmax_output_bwd`` bit for bit at its edges (C = 1, 2, 3,
odd rows, every normalization with and without ``use_ignore``, every label
ignored, labels out of range, ``multi_output`` with inner > 1, a view off
the 16-byte alignment), one launch a call; neither reads anything back in
a call.
"""

import math

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
from mxnet_tpu_torch.kernels import multibox_target as mbt_mod
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
    slope = 0.0 if relu else None
    got = bn_mod.bn_act(*ins, 2e-5, fix_gamma, slope)
    want = bn_mod.bn_act_plain(*ins, 2e-5, fix_gamma, slope)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert bn_mod.LAUNCHES.value == before + 1


# softmax_rows against its plain version: 1e-6 absolute and, beside it,
# 1e-5 of each probability (at C = 10000 a typical one is 3e-8, far below
# the absolute bound; a sum in another order moves a float32 quotient by
# about 1e-6 of itself)
SM_ATOL, SM_RTOL = 1e-6, 1e-5


def _assert_softmax(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=SM_ATOL)
    torch.testing.assert_close(got, want, rtol=SM_RTOL, atol=1e-30)


@pytest.mark.parametrize("shape", [(32, 1000), (1, 1000), (7, 1001)])
def test_softmax_rows_kernel_matches_plain(card, shape):
    x = torch.randn(shape, device=card) * 4
    before = sm_mod.LAUNCHES.value
    got = sm_mod.softmax_rows(x)
    _assert_softmax(got, sm_mod.softmax_rows_plain(x))
    assert sm_mod.LAUNCHES.value == before + 1


def test_kernels_raise_on_what_they_do_not_take(card):
    x = torch.randn(2, 3, 4, 4, device=card)
    stats = [torch.ones(3, device=card) for _ in range(4)]
    with pytest.raises(MXNetError):
        bn_mod.bn_act(x.double(), *[s.double() for s in stats], 1e-5,
                      False, 0.0)
    with pytest.raises(MXNetError):
        bn_mod.bn_act(x.transpose(2, 3), *stats, 1e-5, False, 0.0)
    with pytest.raises(MXNetError):
        bn_mod.bn_act(x, *stats[:3], stats[3].cpu(), 1e-5, False, 0.0)
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
    slope = 0.0 if relu else None
    got = bwd_mod.bn_act_bwd(dy, y, x, mean, var, gamma, kvar, 2e-5,
                             fix_gamma, slope)
    want = bwd_mod.bn_act_bwd_plain(dy, y, x, mean, var, gamma, kvar, 2e-5,
                                    fix_gamma, slope)
    assert bwd_mod.LAUNCHES.value == before + 1  # one pass: the block regime
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
    assert sob_mod.LAUNCHES.value == before + 1  # the count in the launch
    assert torch.equal(got.cpu(), sob_mod.softmax_output_bwd_plain(
        p.cpu(), label.cpu(), kwargs.get("grad_scale", 1.0),
        kwargs.get("ignore_label", -1.0), kwargs.get("use_ignore", False),
        kwargs.get("normalization", "null"),
        kwargs.get("multi_output", False)))


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
    builds = sgd_mod.PACK_BUILDS.value
    for _ in range(2):
        sgd_mod.sgd_mom_multi(ws, gs, moms, lrs, wds, momentum, 1 / 32, clip,
                              cache=cache)
        sgd_mod.sgd_mom_multi_plain(ref[0], gs, ref[1] if moms else None,
                                    lrs, wds, momentum, 1 / 32, clip)
    assert sgd_mod.LAUNCHES.value == before + 2
    assert sgd_mod.PACK_BUILDS.value == builds + 1  # cached between steps
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
    # as planned: one launch while no segment can exceed L_max
    assert nms_mod.LAUNCHES.value == before + nms_mod.plan_for(
        ins[1], None, force).launches
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


# -- SSD training kernels ----------------------------------------------------
@pytest.mark.parametrize("name", [
    "random", "padded rows and an image without objects",
    "grid: IoU at the threshold, shared best anchors",
    "tied and signed-zero logits at the mining boundary",
    "a padded row after an object whose best anchor is anchor 0",
    "mining off", "minimum negative samples"])
def test_multibox_target_kernel_matches_plain_bit_for_bit(card, name):
    """chip_smoke.py's edge inputs (the same sets the CPU tests hold the
    plain version to the reference on)."""
    cs = _chip_smoke()
    anc, label, cls_pred, params = cs.mbt_case(name)
    ins = [torch.from_numpy(t).to(card) for t in (anc, label, cls_pred)]
    before = mbt_mod.LAUNCHES.value
    got = mbt_mod.multibox_target(*ins, *cs.mbt_args(params))
    want = mbt_mod.multibox_target_plain(*ins, *cs.mbt_args(params))
    assert mbt_mod.LAUNCHES.value == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("a, g", [(8096, 16), (1, 1), (1025, 3),
                                  (20000, 40)])
def test_multibox_target_kernel_on_the_class_major_view(card, a, g):
    """Random anchors and objects, the mining keys read through the
    transposed view of class-last scores, as the SSD head hands them."""
    rng = np.random.default_rng(a + g)
    lo = rng.uniform(0, 0.8, (1, a, 2))
    anc = np.concatenate([lo, lo + rng.uniform(0.02, 0.3, (1, a, 2))], 2)
    label = np.full((5, g, 5), -1.0)
    for b in range(4):  # the last image has no object
        for j in range(rng.integers(1, g + 1)):
            x1 = rng.uniform(0, 0.6, 2)
            label[b, j] = [rng.integers(0, 20), *x1,
                           *(x1 + rng.uniform(0.05, 0.4, 2))]
    scores = torch.from_numpy(rng.standard_normal((5, a, 21)).astype(
        np.float32)).to(card)
    args = [torch.from_numpy(anc.astype(np.float32)).to(card),
            torch.from_numpy(label.astype(np.float32)).to(card),
            scores.transpose(1, 2), 0.5, -1.0, 3.0, 0.5, 0,
            (0.1, 0.1, 0.2, 0.2)]
    got = mbt_mod.multibox_target(*args)
    want = mbt_mod.multibox_target_plain(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


L2_BWD_SEEDS = {(32, 512, 37, 37): 100, (3, 5, 7, 9): 200, (2, 3): 300,
                (1, 1000, 1, 1): 400}


@pytest.mark.parametrize("shape", list(L2_BWD_SEEDS))
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_l2norm_channel_bwd_kernel_matches_plain(card, shape, scale):
    # one seed per case, fixed before any result was seen
    gen = torch.Generator(device=card).manual_seed(
        L2_BWD_SEEDS[shape] + int(scale))
    x = torch.randn(shape, generator=gen, device=card)
    g = torch.randn(shape, generator=gen, device=card)
    before = l2_mod.BWD_LAUNCHES.value
    got = l2_mod.l2norm_channel_bwd(x, g, 1e-10, scale)
    want = l2_mod.l2norm_channel_bwd_plain(x, g, 1e-10, scale)
    limit = l2_mod.bwd_limit(x, g, 1e-10, scale, want)
    assert bool(((got - want).abs() <= limit).all())
    assert l2_mod.BWD_LAUNCHES.value == before + 1
    # through autograd: the Function launches both kernels
    xr = x.clone().requires_grad_(True)
    l2_mod.L2NormChannelFn.apply(xr, 1e-10, scale).backward(g)
    assert bool(((xr.grad - want).abs() <= limit).all())


def test_softmax_output_bwd_on_the_class_major_view(card):
    """SSD's SoftmaxOutput: multi_output over the transposed view of
    class-last probabilities, use_ignore, normalization 'valid', about 3/4
    of the labels ignored; the gradient comes back in the same layout."""
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(rng.standard_normal((4, 300, 21)).astype(
        np.float32)).to(card)
    p = torch.softmax(logits, -1).transpose(1, 2)
    label = rng.integers(0, 21, (4, 300)).astype(np.float32)
    label[rng.uniform(size=label.shape) < 0.75] = -1
    label = torch.from_numpy(label).to(card)
    before = sob_mod.LAUNCHES.value
    got = sob_mod.softmax_output_bwd(p, label, 1.0, -1.0, True, "valid",
                                     True)
    assert sob_mod.LAUNCHES.value == before + 1
    want = sob_mod.softmax_output_bwd_plain(p.cpu(), label.cpu(), 1.0, -1.0,
                                            True, "valid", True)
    assert got.shape == p.shape and got.stride() == p.stride()
    assert torch.equal(got.cpu(), want)


def test_ssd_train_kernels_raise_on_what_they_do_not_take(card):
    cs = _chip_smoke()
    anc, label, cls_pred, params = cs.mbt_case("random")
    ins = [torch.from_numpy(t).to(card) for t in (anc, label, cls_pred)]
    args = cs.mbt_args(params)
    with pytest.raises(MXNetError):
        mbt_mod.multibox_target(ins[0], ins[1].double(), ins[2], *args)
    with pytest.raises(MXNetError):
        mbt_mod.multibox_target(ins[0].transpose(1, 2).contiguous()
                                .transpose(1, 2), ins[1], ins[2], *args)
    with pytest.raises(MXNetError):
        mbt_mod.multibox_target(ins[0], ins[1][:, :, :4].contiguous(),
                                ins[2], *args)
    with pytest.raises(MXNetError):
        mbt_mod.multibox_target(ins[0], ins[1], ins[2].cpu(), *args)
    x = torch.randn(2, 8, 3, 3, device=card)
    with pytest.raises(MXNetError):
        l2_mod.l2norm_channel_bwd(x, x.double(), 1e-10)
    with pytest.raises(MXNetError):
        l2_mod.l2norm_channel_bwd(x.transpose(2, 3), x, 1e-10)
    with pytest.raises(MXNetError):
        l2_mod.l2norm_channel_bwd(x, x[:1], 1e-10)


# -- DCGAN: the leaky route of bn_act / bn_act_bwd --------------------------
DCGAN_D_SHAPES = [(64, 128, 16, 16), (64, 256, 8, 8), (64, 512, 4, 4)]


def _edge_bn_inputs(shape, device):
    """Inputs whose pre-activations are exactly 0 and -0.0 (mean 0, inverse
    std 1, gamma 1, beta -0.0: x = +0.0 gives +0.0 and x = -0.0 gives -0.0)
    in channel 0 and constant in channel 1."""
    x, mean, var, gamma, beta = (t.cpu() for t in _bn_inputs(shape, "cpu"))
    x0 = x[:, 0].reshape(-1)
    x0[::3] = 0.0
    x0[1::3] = -0.0
    x[:, 0] = x0.reshape(x[:, 0].shape)
    x[:, 1] = 0.75
    mean[0], var[0], gamma[0], beta[0] = 0.0, 1.0 - 2e-5, 1.0, -0.0
    mean[1] = 0.75
    return [t.to(device) for t in (x, mean, var, gamma, beta)]


@pytest.mark.parametrize("shape", DCGAN_D_SHAPES + [(3, 5, 7, 9), (2, 3)])
@pytest.mark.parametrize("slope", [0.2, 0.0])
@pytest.mark.parametrize("edge", [False, True])
def test_bn_act_leaky_kernel_matches_plain(card, shape, slope, edge):
    ins = (_edge_bn_inputs if edge else _bn_inputs)(shape, card)
    before = bn_mod.LAUNCHES.value, bn_mod.LEAKY_LAUNCHES.value
    got = bn_mod.bn_act(*ins, 2e-5, True, slope)
    want = bn_mod.bn_act_plain(*ins, 2e-5, True, slope)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert bn_mod.LAUNCHES.value == before[0] + 1
    assert bn_mod.LEAKY_LAUNCHES.value == before[1] + (1 if slope else 0)
    if edge and slope:  # exact zeros keep their sign under the slope
        zeros = want[:, 0] == 0
        assert torch.signbit(want[:, 0][zeros]).unique().tolist() == [
            False, True]  # both signs are there to compare
        assert torch.equal(torch.signbit(got[:, 0][zeros]),
                           torch.signbit(want[:, 0][zeros]))
    if not slope:  # the ReLU: +0.0 for every negative pre-activation
        t = bn_mod.bn_act_plain(*ins, 2e-5, True)
        assert not torch.signbit(got[t < 0]).any()


@pytest.mark.parametrize("shape", DCGAN_D_SHAPES + [(9, 4, 3, 3), (5, 3)])
@pytest.mark.parametrize("slope", [0.2, 0.0])
@pytest.mark.parametrize("batch_stats", [True, False])
def test_bn_act_bwd_leaky_kernel_matches_plain(card, shape, slope,
                                               batch_stats):
    dy, _y, x, mean, var, gamma, kvar = _bwd_inputs(shape, card)
    t = x - 0.1
    t.view(-1)[::5] = 0.0  # the gradient at t == 0 is the slope's
    y = torch.where(t > 0, t, slope * t)
    kvar = kvar if batch_stats else None
    before = bwd_mod.LAUNCHES.value, bwd_mod.LEAKY_LAUNCHES.value
    got = bwd_mod.bn_act_bwd(dy, y, x, mean, var, gamma, kvar, 2e-5, False,
                             slope)
    want = bwd_mod.bn_act_bwd_plain(dy, y, x, mean, var, gamma, kvar, 2e-5,
                                    False, slope)
    assert bwd_mod.LAUNCHES.value == before[0] + 1  # the block regime
    assert bwd_mod.LEAKY_LAUNCHES.value == before[1] + (1 if slope else 0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)


def test_leaky_kernels_refuse_a_negative_slope(card):
    ins = _bn_inputs((2, 3, 4, 4), card)
    with pytest.raises(MXNetError):
        bn_mod.bn_act(*ins, 2e-5, False, -0.2)
    dy, y, x, mean, var, gamma, kvar = _bwd_inputs((2, 3, 4, 4), card)
    with pytest.raises(MXNetError):
        bwd_mod.bn_act_bwd(dy, y, x, mean, var, gamma, kvar, 2e-5, False,
                           -0.2)


# -- the redesigned softmax_rows and sgd_mom_multi ---------------------------
SM_BORDER_COLS = [1, 2, 21, 31, 32, 33, 1000, 4096, 4097, 10000, 14000,
                  60000]


@pytest.mark.parametrize("cols", SM_BORDER_COLS)
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_softmax_rows_at_the_regime_borders(card, cols, offset):
    """Each regime (narrow <= 32 < middle <= 4096 < wide, and the loop past
    the card's shared memory) on aligned rows and on a view at a float
    offset, which the narrow tile loads as a ragged head and tail beside
    its bulk copy and stores with 4-byte stores; 1e-6 absolute and 1e-5
    relative."""
    rows = 517 if cols <= 32 else 5  # a partial last tile of 256 rows
    rng = np.random.default_rng(cols + offset)
    base = torch.from_numpy((rng.standard_normal(rows * cols + offset) * 4)
                            .astype(np.float32)).to(card)
    x = base[offset:].view(rows, cols)
    before = sm_mod.LAUNCHES.value
    got = sm_mod.softmax_rows(x)
    assert sm_mod.LAUNCHES.value == before + 1
    _assert_softmax(got, sm_mod.softmax_rows_plain(x))


@pytest.mark.parametrize("shape", [(517, 21), (64, 1000), (8, 10000),
                                   (2, 60000)])
@pytest.mark.parametrize("offset", [0, 1])
def test_softmax_rows_on_unit_scale_inputs(card, shape, offset):
    """One case per regime on unit-scale inputs, where every probability
    lies near 1/C: each is held to 1e-5 of itself, the head and tail
    columns of a view included."""
    rows, cols = shape
    rng = np.random.default_rng(cols + offset)
    base = torch.from_numpy(rng.standard_normal(rows * cols + offset)
                            .astype(np.float32)).to(card)
    x = base[offset:].view(rows, cols)
    _assert_softmax(sm_mod.softmax_rows(x), sm_mod.softmax_rows_plain(x))


@pytest.mark.parametrize("shape", [(259072, 21), (1024, 10000), (32, 1000)])
@pytest.mark.parametrize("offset", [0, 1])
def test_softmax_rows_at_the_path_shapes(card, shape, offset):
    rows, cols = shape
    base = torch.randn(rows * cols + offset, device=card) * 4
    x = base[offset:].view(rows, cols)
    _assert_softmax(sm_mod.softmax_rows(x), sm_mod.softmax_rows_plain(x))


def _views(rng, sizes, offset, scale, device):
    """Tensors of ``sizes``, each a view ``offset`` floats into its storage
    (1: no tensor 16-byte aligned)."""
    return [torch.from_numpy((rng.standard_normal(n + offset) * scale)
                             .astype(np.float32)).to(device)[offset:]
            for n in sizes]


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("momentum, clip", [(0.9, -1.0), (0.9, 0.005),
                                            (0.0, -1.0)])
def test_sgd_mom_multi_bit_for_bit_on_odd_sizes_and_views(card, offset,
                                                          momentum, clip):
    """Sizes that are no multiple of 4 (the scalar tail), whole and partial
    4096-element chunks, aligned tensors (16-byte accesses) and views that
    break the alignment (the scalar path): bit for bit."""
    rng = np.random.default_rng(20 + offset)
    sizes = [1, 3, 5, 4096, 4097, 70001, 8191, 2]
    ws, gs, ms = (_views(rng, sizes, offset, s, card)
                  for s in (0.05, 0.01, 0.001))
    moms = ms if momentum else None
    lrs, wds = [0.1, 0.05] * 4, [1e-4, 0.0] * 4
    w2, m2 = [t.clone() for t in ws], [t.clone() for t in ms]
    sgd_mod.sgd_mom_multi(ws, gs, moms, lrs, wds, momentum, 1 / 32, clip)
    sgd_mod.sgd_mom_multi_plain(w2, gs, m2 if moms else None, lrs, wds,
                                momentum, 1 / 32, clip)
    for got, want in zip(ws + ms, w2 + m2):
        assert torch.equal(got, want)


@pytest.mark.parametrize("guarded", [False, True])
def test_sgd_mom_multi_over_more_tensors_than_one_launch_holds(card,
                                                               guarded):
    """CAP + 37 tensors (plus restores under the guard) take two launches
    (four under the guard): bit for bit; then a NaN in the second launch's
    gradients skips the whole step and restores every statistic."""
    rng = np.random.default_rng(21)
    n = sgd_mod.CAP + 37
    sizes = [100 + i for i in range(n)]
    ws, gs, ms = (_views(rng, sizes, 0, 1.0, card) for _ in range(3))
    aux = [torch.ones(600 + i, device=card) for i in range(5)]
    snap = [torch.zeros_like(a) for a in aux]
    guard = (sgd_mod.Guard(torch.zeros(2, dtype=torch.int32, device=card),
                           list(zip(aux, snap))) if guarded else None)
    lrs, wds = [0.1] * n, [1e-4] * n
    w2, m2 = [t.clone() for t in ws], [t.clone() for t in ms]
    before = sgd_mod.LAUNCHES.value
    sgd_mod.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1.0, -1.0, guard=guard)
    assert sgd_mod.LAUNCHES.value == before + (4 if guarded else 2)
    sgd_mod.sgd_mom_multi_plain(w2, gs, m2, lrs, wds, 0.9, 1.0, -1.0)
    for got, want in zip(ws + ms, w2 + m2):
        assert torch.equal(got, want)
    if not guarded:
        return
    assert guard.counters.tolist() == [0, 0]
    gs[-1][7] = float("nan")
    sgd_mod.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1.0, -1.0, guard=guard)
    assert guard.counters.tolist() == [1, 1]
    for got, want in zip(ws + ms + aux, w2 + m2 + snap):
        assert torch.equal(got, want)


def test_sgd_mom_multi_packs_once_and_rechecks_the_gradients(card):
    """The weights and momenta are validated and packed once; new gradient
    tensors each call are still checked, and a weight that moved is
    packed anew."""
    rng = np.random.default_rng(22)
    ws, gs, ms = (_views(rng, [10, 4099], 0, 1.0, card) for _ in range(3))
    cache = {}
    builds = sgd_mod.PACK_BUILDS.value
    for _ in range(3):
        gs = [g.clone() for g in gs]
        sgd_mod.sgd_mom_multi(ws, gs, ms, [0.1] * 2, [0.0] * 2, 0.9, 1.0,
                              -1.0, cache=cache)
    assert sgd_mod.PACK_BUILDS.value == builds + 1
    with pytest.raises(MXNetError):
        sgd_mod.sgd_mom_multi(ws, [gs[0].double(), gs[1]], ms, [0.1] * 2,
                              [0.0] * 2, 0.9, 1.0, -1.0, cache=cache)
    with pytest.raises(MXNetError):  # strided: not the flat layout
        sgd_mod.sgd_mom_multi(ws, [gs[0], torch.zeros(2 * 4099,
                                                       device=card)[::2]],
                              ms, [0.1] * 2, [0.0] * 2, 0.9, 1.0, -1.0,
                              cache=cache)
    with pytest.raises(MXNetError):
        sgd_mod.sgd_mom_multi(ws, [gs[0], gs[1][:4098]], ms, [0.1] * 2,
                              [0.0] * 2, 0.9, 1.0, -1.0, cache=cache)
    ws[1] = ws[1].clone()
    sgd_mod.sgd_mom_multi(ws, gs, ms, [0.1] * 2, [0.0] * 2, 0.9, 1.0, -1.0,
                          cache=cache)
    assert sgd_mod.PACK_BUILDS.value == builds + 2
    with pytest.raises(MXNetError):
        sgd_mod.sgd_mom_multi([ws[0].double(), ws[1]], gs, ms, [0.1] * 2,
                              [0.0] * 2, 0.9, 1.0, -1.0, cache=cache)


def test_sgd_mom_multi_raises_on_a_gradient_of_another_shape(card):
    """A contiguous gradient with the weight's size but not its shape, a
    (b, a) gradient for an (a, b) weight, raises as the plain version
    does: the kernel's flat view would apply it in the wrong order."""
    ws = [torch.zeros(3, 5, device=card), torch.zeros(7, device=card)]
    ms = [torch.zeros_like(w) for w in ws]
    gs = [torch.ones(3, 5, device=card), torch.ones(7, device=card)]
    cache = {}
    sgd_mod.sgd_mom_multi(ws, gs, ms, [0.1] * 2, [0.0] * 2, 0.9, 1.0, -1.0,
                          cache=cache)
    with pytest.raises(MXNetError):
        sgd_mod.sgd_mom_multi(ws, [torch.ones(5, 3, device=card), gs[1]],
                              ms, [0.1] * 2, [0.0] * 2, 0.9, 1.0, -1.0,
                              cache=cache)
    with pytest.raises(MXNetError):
        sgd_mod.sgd_mom_multi(ws, [gs[0].reshape(15), gs[1]], ms, [0.1] * 2,
                              [0.0] * 2, 0.9, 1.0, -1.0, cache=cache)


def test_adam_multi_unchanged_bit_for_bit(card):
    """adam_multi keeps its own table and probe: under the guard its update
    is still the plain version's, bit for bit."""
    ws, gs, ms, vs = _adam_inputs(card)
    aux, snap = torch.ones(9000, device=card), torch.zeros(9000, device=card)
    guard = sgd_mod.Guard(torch.zeros(2, dtype=torch.int32, device=card),
                          [(aux, snap)])
    ref = [[t.clone() for t in x] for x in (ws, ms, vs)]
    args = ([3e-3] * 5, [1e-4] * 5, 0.9, 0.999, 1e-8, 1 / 32, -1.0)
    adam_mod.adam_multi(ws, gs, ms, vs, *args, guard=guard)
    adam_mod.adam_multi_plain(ref[0], gs, ref[1], ref[2], *args)
    assert guard.counters.tolist() == [0, 0]
    for got, want in zip(ws + ms + vs, ref[0] + ref[1] + ref[2]):
        assert torch.equal(got, want)


# -- the redesigned bn_act_bwd and lstm_cell ---------------------------------
def _bn_bwd_border_shapes():
    """Shapes on each side of the block limit and of the cluster limit of
    this card (N = 1, C = 3: m is the plane), two phases over 9 images of
    planes a multiple of 4 long (16-byte accesses, two splits), planes of
    49 and 16, C = 3 and N = 1."""
    smem, cluster = bwd_mod.device_limits(0)
    cap, limit = bwd_mod.block_elems(smem), bwd_mod.block_limit(smem)
    return [(1, 3, limit), (1, 3, limit + 1), (1, 3, limit + 4),
            (1, 3, cluster * cap), (1, 3, cluster * cap + 1),
            (9, 2, -(-cluster * cap // 9 // 4) * 4 + 4),
            (2, 3, 7, 7), (4, 5, 4, 4), (1, 3, 5, 5), (3, 7, 1, 1)]


BN_ROUTES = [None, 0.0, 0.2]


def _bn_bwd_border_inputs(shape, device, offset):
    """dy, y (for slopes 0 and 0.2), x and the statistics; the three big
    tensors are views ``offset`` floats into their storage."""
    rng = np.random.default_rng(sum(shape) + offset)
    c = shape[1]

    def big(a):
        flat = np.concatenate([np.zeros(offset), a.ravel()])
        return torch.from_numpy(flat.astype(np.float32)).to(device)[
            offset:].view(shape)

    x = rng.standard_normal(shape)
    stats = [rng.uniform(-0.3, 0.3, c), rng.uniform(0.5, 2.0, c),
             rng.uniform(0.5, 1.5, c), rng.choice([0.0, 0.5, 1.0], c)]
    t = x - 0.1
    t.reshape(-1)[::5] = 0.0
    ys = {s: big(np.where(t > 0, t, s * t)) for s in (0.0, 0.2)}
    return (big(rng.standard_normal(shape)), ys, big(x),
            [torch.from_numpy(a.astype(np.float32)).to(device)
             for a in stats])


@pytest.mark.parametrize("border", range(10))
@pytest.mark.parametrize("slope", BN_ROUTES)
def test_bn_act_bwd_at_the_regime_borders(card, border, slope):
    """Every route, with and without batch statistics, with and without
    fix_gamma, on each side of the block and cluster limits and at odd
    planes: within the plain version's tolerances, one launch a call in
    the block and cluster regimes (two in the two-phase one), and two
    calls bit for bit the same."""
    shape = _bn_bwd_border_shapes()[border]
    dy, ys, x, (mean, var, gamma, kvar) = _bn_bwd_border_inputs(
        shape, card, 0)
    y = None if slope is None else ys[slope]
    p = bwd_mod.plan_for(x)
    for batch_stats in (True, False):
        for fix_gamma in (False, True):
            args = (dy, y, x, mean, var, gamma,
                    kvar if batch_stats else None, 2e-5, fix_gamma, slope)
            before = bwd_mod.LAUNCHES.value, bwd_mod.LEAKY_LAUNCHES.value
            got = bwd_mod.bn_act_bwd(*args)
            assert bwd_mod.LAUNCHES.value == before[0] + p.launches
            assert bwd_mod.LEAKY_LAUNCHES.value == before[1] + (
                p.launches if slope else 0)
            again = bwd_mod.bn_act_bwd(*args)
            want = bwd_mod.bn_act_bwd_plain(*args)
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
            for g, w in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
            if fix_gamma:
                assert not got[1].any()
            for a, b in zip(got, again):
                assert torch.equal(a, b)
            if not batch_stats:  # dx = g * invstd * dy': zeros' signs
                zeros = want[0] == 0
                assert torch.equal(torch.signbit(got[0][zeros]),
                                   torch.signbit(want[0][zeros]))


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("slope", BN_ROUTES)
def test_bn_act_bwd_on_views_at_a_float_offset(card, offset, slope):
    """Inputs one and three floats off the 16-byte alignment take 4-byte
    accesses, in the block and the cluster regimes: within the plain
    version's tolerances, and two calls bit for bit the same."""
    smem, _cluster = bwd_mod.device_limits(0)
    for shape in [(4, 6, 8, 8), (1, 3, 3 * bwd_mod.block_limit(smem))]:
        dy, ys, x, (mean, var, gamma, kvar) = _bn_bwd_border_inputs(
            shape, card, offset)
        y = None if slope is None else ys[slope]
        for k in (kvar, None):
            args = (dy, y, x, mean, var, gamma, k, 2e-5, False, slope)
            got = bwd_mod.bn_act_bwd(*args)
            again = bwd_mod.bn_act_bwd(*args)
            want = bwd_mod.bn_act_bwd_plain(*args)
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
            for g, w in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
            for a, b in zip(got, again):
                assert torch.equal(a, b)


def test_lstm_cell_outputs_share_one_allocation(card):
    i2h, h2h, c, _dh, _dc = _lstm_inputs(card, 6, 12)
    next_h, next_c, act = lstm_mod.lstm_cell(i2h, h2h, c, 1.0)
    base = next_h.data_ptr()
    assert next_c.data_ptr() == base + 6 * 12 * 4
    assert act.data_ptr() == base + 2 * 6 * 12 * 4
    assert all(t.is_contiguous() for t in (next_h, next_c, act))
    want = lstm_mod.lstm_cell_plain(i2h, h2h, c, 1.0)
    for g, w in zip((next_h, next_c, act), want):
        torch.testing.assert_close(g, w, **LSTM_TOL)
    # the training step through autograd: the saved views give the VJP
    ins = [t.clone().requires_grad_(True) for t in (i2h, h2h, c)]
    h, cc = lstm_mod.LSTMCellFn.apply(*ins, 1.0)
    (h.sum() + 2 * cc.sum()).backward()
    ref = [t.clone().requires_grad_(True) for t in (i2h, h2h, c)]
    rh, rc, _ = lstm_mod.lstm_cell_plain(*ref, 1.0)
    (rh.sum() + 2 * rc.sum()).backward()
    for a, b in zip(ins, ref):
        torch.testing.assert_close(a.grad, b.grad, **LSTM_TOL)


# -- the redesigned nms and bn_stats -----------------------------------------
@pytest.mark.parametrize("force, classes", [(False, 3), (True, 3),
                                            (False, None)])
def test_nms_at_the_plan_borders(card, force, classes):
    """Six images of L_max + 130 anchors: a class of L_max - 1, L_max and
    L_max + 1 valid boxes (short, short, long), a class id past the last
    one on an image too long for a segment block, a class id of -1 on one
    that fits, and an image of short segments: bit for bit, the plan's
    launches, two calls the same."""
    cs = _chip_smoke()
    ins = cs.nms_border_inputs(torch, card, nms_mod.plan_for(
        torch.empty(1, 8096, device=card), 20).lmax, 51)
    p = nms_mod.plan_for(ins[1], classes, force)
    assert p.launches == 3
    before = nms_mod.LAUNCHES.value
    got = nms_mod.nms(*ins, 0.01, 0.5, force, classes)
    assert nms_mod.LAUNCHES.value == before + p.launches
    assert torch.equal(got, nms_mod.nms_plain(*ins, 0.01, 0.5, force))
    assert torch.equal(got, nms_mod.nms(*ins, 0.01, 0.5, force, classes))


@pytest.mark.parametrize("a, classes, one_class, force", [
    (8096, 20, True, False), (8096, 20, False, True), (1, 20, False, False),
    (65, 3, False, False), (1000, 3, True, False), (7000, 20, False, True)])
def test_nms_on_long_segments_and_odd_sizes(card, a, classes, one_class,
                                            force):
    """One class holding all 8096 anchors, or force on them (long
    segments: the mask and chain kernels), A = 1, A not a multiple of 64:
    bit for bit."""
    ins = list(_chip_smoke().nms_grid_inputs(torch, card, seed=a, n=2, a=a,
                                             classes=classes))
    if one_class:
        ins[2] = torch.full_like(ins[2], classes - 1)
    got = nms_mod.nms(*ins, 0.01, 0.45, force, classes)
    assert torch.equal(got, nms_mod.nms_plain(*ins, 0.01, 0.45, force))


def test_nms_with_class_ids_out_of_range(card):
    """A valid anchor of class id -1 or ``classes`` makes its image one
    segment (the class test in the IoU test), so the rows stay the plain
    version's, whose class test compares the ids as they are."""
    ins = list(_chip_smoke().nms_grid_inputs(torch, card, seed=9, n=3,
                                             a=1000))
    cls_id = ins[2].cpu()
    cls_id[0, 3], cls_id[1, 5] = 3, -1
    ins[2] = cls_id.to(card)
    score = ins[1].cpu()
    score[0, 3] = score[1, 5] = 0.8
    ins[1] = score.to(card)
    ins[3] = torch.argsort(-ins[1], dim=1, stable=True)
    got = nms_mod.nms(*ins, 0.01, 0.5, False, 3)
    assert torch.equal(got, nms_mod.nms_plain(*ins, 0.01, 0.5, False))
    assert float(got[0, 3, 0]) in (3.0, -1.0)


_T = stats_mod.BLOCK_TARGET  # each side of a block, 2 and 16 blocks
STATS_BORDERS = [(1, 3, _T - 1), (1, 3, _T), (1, 3, _T + 1),
                 (1, 3, 2 * _T + 1), (1, 3, 16 * _T), (1, 3, 16 * _T + 1),
                 (1, 3, 32 * _T + 4), (2, 3, 7, 7), (4, 5, 4, 4), (1, 3, 5, 5),
                 (3, 7, 1, 1), (5, 3), (32, 64, 112, 112), (32, 256, 56, 56),
                 (32, 128, 28, 28), (32, 1024, 14, 14), (32, 2048, 7, 7),
                 (64, 64, 32, 32), (64, 128, 16, 16), (64, 512, 4, 4)]


def _check_stats(x, offset=0):
    """bn_stats against its plain version (mean rtol 1e-5 / atol 1e-6, the
    variance also the anchored formula's cancellation), kvar exactly (0.5
    on the constant channel 0: 1.5 over an anchor of 1, so every partial
    sum is exact), the plan's one launch, two calls bit for bit."""
    c = x.shape[1]
    rng = np.random.default_rng(c + offset)
    x[:, 0] = 1.5
    mm = torch.from_numpy(rng.uniform(-0.1, 0.1, c).astype(np.float32))
    mm[0] = 1.0
    mv = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    mm, mv = mm.to(x.device), mv.to(x.device)
    mm2, mv2, mm3, mv3 = (t.clone() for t in (mm, mv, mm, mv))
    assert stats_mod.plan_for(x).launches == 1
    before = stats_mod.LAUNCHES.value
    got = stats_mod.bn_stats(x, mm, mv, 0.9)
    assert stats_mod.LAUNCHES.value == before + 1
    again = stats_mod.bn_stats(x, mm3, mv3, 0.9)
    anchor = mm2.clone()
    want = stats_mod.bn_stats_plain(x, mm2, mv2, 0.9)
    cancel = 8 * 2.0 ** -23 * float((want[0] - anchor).abs().max()) ** 2
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6 + cancel)
    torch.testing.assert_close(mm, mm2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mv, mv2, rtol=1e-5, atol=1e-6 + cancel)
    assert torch.equal(got[2], want[2]) and float(got[2][0]) == 0.5
    for a_, b_ in zip(got + (mm, mv), again + (mm3, mv3)):
        assert torch.equal(a_, b_)


@pytest.mark.parametrize("shape", STATS_BORDERS)
def test_bn_stats_at_the_regime_borders_and_path_shapes(card, shape):
    x = torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(
        shape).astype(np.float32) + 0.3).to(card)
    _check_stats(x)


@pytest.mark.parametrize("shape", [(4, 6, 8, 8), (1, 3, 3 * _T),
                                   (2, 3, 7, 7), (8, 64, 16, 16)])
@pytest.mark.parametrize("offset", [1, 3])
def test_bn_stats_on_views_at_a_float_offset(card, shape, offset):
    """Views one and three floats off the 16-byte alignment take 4-byte
    loads (another summation order than an aligned copy)."""
    flat = np.random.default_rng(offset).standard_normal(
        math.prod(shape) + offset).astype(np.float32)
    x = torch.from_numpy(flat).to(card)[offset:].view(shape)
    _check_stats(x, offset)


def test_nms_and_bn_stats_read_nothing_back(card):
    """Neither wrapper copies to or from the host, reads a scalar or
    synchronises in a call: torch.profiler over three calls records none
    beyond an empty window's."""
    cs = _chip_smoke()
    ins = cs.nms_grid_inputs(torch, card, seed=7, n=4, a=8096, classes=20)
    assert cs.host_syncs(torch, lambda: nms_mod.nms(
        *ins, 0.01, 0.45, False, 20)) == 0
    x = torch.randn(32, 256, 28, 28, device=card)
    mm, mv = torch.zeros(256, device=card), torch.ones(256, device=card)
    assert cs.host_syncs(torch, lambda: stats_mod.bn_stats(
        x, mm, mv, 0.9)) == 0


# -- the redesigned l2norm_channel_bwd and softmax_output_bwd ---------------
def _l2_bwd_edges():
    c2 = l2_mod.ONCHIP_C + 1  # the least C of the two-pass regime
    return [(3, 1, 5, 7), (4, 6, 1, 1), (5, 3), (7, 21, 3, 3), (3, 8, 5, 7),
            (1, 512, 37, 37), (2, c2 - 1, 3, 5), (2, c2, 3, 5),
            (3, 2 * c2 + 3, 1, 1)]


@pytest.mark.parametrize("edge", range(9))
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_l2norm_channel_bwd_at_the_edges(card, edge, scale):
    shape = _l2_bwd_edges()[edge]
    rng = np.random.default_rng(edge * 10 + int(scale))
    x, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card) for _ in range(2))
    plan = l2_mod.bwd_plan(shape[1])
    assert plan.regime == ("two_pass" if edge >= 7 else "onchip")
    before = l2_mod.BWD_LAUNCHES.value
    got = l2_mod.l2norm_channel_bwd(x, g, 1e-10, scale)
    assert l2_mod.BWD_LAUNCHES.value == before + 1
    assert torch.equal(got, l2_mod.l2norm_channel_bwd(x, g, 1e-10, scale))
    want = l2_mod.l2norm_channel_bwd_plain(x, g, 1e-10, scale)
    limit = l2_mod.bwd_limit(x, g, 1e-10, scale, want)
    assert bool(((got - want).abs() <= limit).all())


def _so_edge_inputs(shape, multi, rule, device):
    rng = np.random.default_rng(sum(shape) + len(rule))
    p = torch.softmax(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)), 1 if multi else -1)
    classes = shape[1] if multi else shape[-1]
    lshape = (shape[0],) + shape[2:] if multi else shape[:-1]
    label = rng.integers(-1, classes, lshape).astype(np.float32)
    if rule == "ignored":
        label[...] = -1
    elif rule == "wild":
        label = rng.choice(np.asarray([-1, 0, 2.7, -0.5, 3e9, -3e9, 10, 11],
                                      np.float32), lshape)
    if rule == "offset":  # one float off the 16-byte alignment
        flat = torch.empty(p.numel() + 1)
        flat[1:] = p.reshape(-1)
        return flat.to(device)[1:].view(shape), torch.from_numpy(label).to(
            device)
    return p.to(device), torch.from_numpy(label).to(device)


@pytest.mark.parametrize("shape, multi, rule", [
    ((7, 1), False, "random"), ((33, 21), False, "random"),
    ((1, 1000), False, "random"), ((9, 3), False, "random"),
    ((13, 2), False, "random"), ((9, 21), False, "ignored"),
    ((8, 11), False, "wild"), ((33, 21), False, "offset"),
    ((3, 5, 2, 7), True, "random"), ((1, 3, 1, 1), True, "random")])
@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
def test_softmax_output_bwd_at_the_edges(card, shape, multi, rule,
                                         normalization, use_ignore):
    p, label = _so_edge_inputs(shape, multi, rule, card)
    args = (0.5, -1.0, use_ignore, normalization, multi)
    before = sob_mod.LAUNCHES.value
    got = sob_mod.softmax_output_bwd(p, label, *args)
    assert sob_mod.LAUNCHES.value == before + 1
    assert got.shape == p.shape
    assert torch.equal(got.cpu(), sob_mod.softmax_output_bwd_plain(
        p.cpu(), label.cpu(), *args))


def test_softmax_output_bwd_counts_on_two_streams_at_once(card):
    """Counting calls ('valid' under use_ignore) queued on two streams at
    once, with counts that differ, each keep their own count: the slots of
    the count belong to the launch's stream."""
    rng = np.random.default_rng(17)
    p = torch.softmax(torch.from_numpy(rng.standard_normal(
        (4096, 21)).astype(np.float32)), -1).to(card)
    labels = []
    for share in (0.1, 0.9):
        lab = rng.integers(0, 21, 4096).astype(np.float32)
        lab[rng.uniform(size=4096) < share] = -1
        labels.append(torch.from_numpy(lab).to(card))
    wants = [sob_mod.softmax_output_bwd_plain(p.cpu(), lab.cpu(), 1.0, -1.0,
                                              True, "valid", False)
             for lab in labels]
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    torch.cuda.synchronize(card)
    outs = [[], []]
    for _ in range(50):
        for k in (0, 1):
            with torch.cuda.stream(streams[k]):
                outs[k].append(sob_mod.softmax_output_bwd(
                    p, labels[k], 1.0, -1.0, True, "valid", False))
    torch.cuda.synchronize(card)
    for k in (0, 1):
        for got in outs[k]:
            assert torch.equal(got.cpu(), wants[k])


def test_l2norm_bwd_and_softmax_output_bwd_read_nothing_back(card):
    """torch.profiler over three calls of each records no copy to or from
    the host and no synchronisation beyond an empty window's."""
    cs = _chip_smoke()
    x = torch.randn(32, 512, 37, 37, device=card)
    assert cs.host_syncs(torch, lambda: l2_mod.l2norm_channel_bwd(
        x, x, 1e-10, 20.0)) == 0
    p = torch.softmax(torch.randn(4, 8096, 21, device=card), -1)
    label = torch.randint(-1, 21, (4, 8096), device=card).float()
    assert cs.host_syncs(torch, lambda: sob_mod.softmax_output_bwd(
        p.transpose(1, 2), label, 1.0, -1.0, True, "valid", True)) == 0
