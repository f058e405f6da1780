"""The redesigned ``bn_act_bwd`` and ``lstm_cell`` wrappers on the CPU, where
they take their plain versions: ``bn_act_bwd``'s regime planner, exactly at
each border; the single allocation of ``lstm_cell``'s outputs and the
backward through it; and ``bn_act_bwd_plain`` at the planner's border
shapes against ``jax.vjp`` of the JAX package's BatchNorm followed by its
LeakyReLU or ReLU.

Inputs come from numpy with a seed. Tolerances, float32 on both sides:
``dx`` rtol 1e-4 / atol 1e-5 and the channel sums ``dgamma``/``dbeta``
rtol 1e-4 / atol ``m * 2**-24`` (``m`` elements per channel: the sums run
in another order), the card's tolerances for the kernel against its plain
version; the LSTM cell's gradients rtol 1e-5 / atol 1e-6 (the same
operations, the views of one buffer against separate tensors).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.registry import OpMode as JOpMode

from mxnet_tpu_torch.kernels import bn_act_bwd as bwd_mod
from mxnet_tpu_torch.kernels import bn_stats as stats_mod
from mxnet_tpu_torch.kernels import lstm_cell as lstm_mod

# the limits the C side reported on an NVIDIA H100 80GB HBM3
# (bn_act_bwd.device_limits): dynamic shared memory per block, cluster
H100_SMEM, H100_CLUSTER = 232176, 16
CAP = bwd_mod.block_elems(H100_SMEM)  # 29020 elements fit a block
DX_TOL = dict(rtol=1e-4, atol=1e-5)
LSTM_TOL = dict(rtol=1e-5, atol=1e-6)


def _invariants(p, n, c, hw, smem, cluster):
    """What the C side checks of a one-pass plan."""
    m = n * hw
    assert p.launches == 1 and 1 <= p.cluster <= cluster
    assert p.chunk % 4 == 0 and p.chunk * p.cluster >= m
    assert p.chunk * (p.cluster - 1) < m  # no block without elements
    assert p.chunk * bwd_mod.ELEM_BYTES * p.channels_per_block <= smem
    assert p.group % 32 == 0 and p.threads == p.group * p.channels_per_block
    assert p.threads <= bwd_mod.MAX_THREADS
    assert p.cluster == 1 or p.channels_per_block == 1
    assert p.grid == -(-c // p.channels_per_block) * p.cluster


T = bwd_mod.BLOCK_TARGET  # 16384: the block regime's limit on the H100


@pytest.mark.parametrize("m, regime, cluster", [
    (T - 1, "block", 1), (T, "block", 1), (T + 1, "cluster", 2),
    (2 * T, "cluster", 2), (2 * T + 1, "cluster", 3),
    (H100_CLUSTER * T, "cluster", 16), (H100_CLUSTER * T + 1, "cluster", 16),
    (H100_CLUSTER * CAP - 1, "cluster", 16),
    (H100_CLUSTER * CAP, "cluster", 16),
    (H100_CLUSTER * CAP + 1, "two_phase", 1),
])
def test_plan_at_the_block_and_cluster_limits(m, regime, cluster):
    assert bwd_mod.block_limit(H100_SMEM) == T < CAP
    p = bwd_mod.plan(1, 3, m, H100_SMEM, H100_CLUSTER)
    assert (p.regime, p.cluster) == (regime, cluster)
    if regime == "two_phase":
        assert p.launches == 2 and p.grid == 3  # one split: N = 1
    else:
        _invariants(p, 1, 3, m, H100_SMEM, H100_CLUSTER)


@pytest.mark.parametrize("smem, cluster", [(4096, 8), (232176, 8),
                                           (65536, 16), (20, 16)])
def test_plan_follows_the_limits_it_is_given(smem, cluster):
    cap = bwd_mod.block_elems(smem)
    assert cap == smem // 8 // 4 * 4
    if not cap:  # no element fits a block: every call takes two phases
        assert bwd_mod.plan(2, 3, 5, smem, cluster).regime == "two_phase"
        return
    limit = bwd_mod.block_limit(smem)
    assert limit == min(cap, T)
    for m, regime in [(limit, "block"), (limit + 1, "cluster"),
                      (cluster * cap, "cluster"),
                      (cluster * cap + 1, "two_phase")]:
        p = bwd_mod.plan(1, 5, m, smem, cluster)
        assert p.regime == regime, (m, p)
        if regime != "two_phase":
            _invariants(p, 1, 5, m, smem, cluster)


@pytest.mark.parametrize("n, c, hw, cpb, group", [
    (2, 3, 1, 3, 32),       # two elements a channel: one warp each
    (64, 512, 16, 4, 64),   # DCGAN's (64, 512, 4, 4)
    (1, 1, 16, 1, 32),      # one channel: nothing to pack
    (8, 20, 16, 8, 32),     # 128 elements: eight warps, one block
    (32, 2048, 49, 2, 128),  # ResNet's 7x7 stage: 1568 elements
    (32, 1024, 196, 1, 512),  # its 14x14 stage: 6272, at most 512 threads
])
def test_plan_packs_small_channels_into_a_block(n, c, hw, cpb, group):
    p = bwd_mod.plan(n, c, hw, H100_SMEM, H100_CLUSTER)
    assert p.regime == "block"
    assert (p.channels_per_block, p.group) == (cpb, group)
    _invariants(p, n, c, hw, H100_SMEM, H100_CLUSTER)


def test_every_path_shape_plans_one_launch_on_the_h100():
    """ResNet-50's 12 training shapes at batch 32 (bn0 a 16-block cluster
    of 1024-thread blocks) and DCGAN's: one launch a call, so 50 and 13
    launches a step."""
    resnet = [(32, 64, 112, 112), (32, 64, 56, 56), (32, 256, 56, 56),
              (32, 128, 56, 56), (32, 128, 28, 28), (32, 512, 28, 28),
              (32, 256, 28, 28), (32, 256, 14, 14), (32, 1024, 14, 14),
              (32, 512, 14, 14), (32, 512, 7, 7), (32, 2048, 7, 7)]
    dcgan = [(64, 128, 16, 16), (64, 256, 8, 8), (64, 512, 4, 4),
             (64, 64, 32, 32)]
    for n, c, h, w in resnet + dcgan:
        p = bwd_mod.plan(n, c, h * w, H100_SMEM, H100_CLUSTER)
        assert p.launches == 1, (n, c, h, w, p)
        _invariants(p, n, c, h * w, H100_SMEM, H100_CLUSTER)
    bn0 = bwd_mod.plan(32, 64, 112 * 112, H100_SMEM, H100_CLUSTER)
    assert (bn0.regime, bn0.cluster, bn0.group) == ("cluster", 16, 1024)


# -- lstm_cell: one allocation for the forward's three outputs ---------------
@pytest.mark.parametrize("rows, hidden", [(4, 8), (3, 5), (32, 200)])
def test_lstm_cell_outputs_are_disjoint_views_of_one_buffer(rows, hidden):
    like = torch.empty(0)
    next_h, next_c, act = lstm_mod.cell_outputs(like, rows, hidden, True)
    assert next_h.shape == next_c.shape == (rows, hidden)
    assert act.shape == (rows, 4 * hidden)
    assert all(t.is_contiguous() for t in (next_h, next_c, act))
    base = next_h.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for t in (next_c, act))
    spans = sorted((t.data_ptr(), t.data_ptr() + 4 * t.numel())
                   for t in (next_h, next_c, act))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] - spans[0][0] == 4 * 6 * rows * hidden
    h, c, none = lstm_mod.cell_outputs(like, rows, hidden, False)
    assert none is None and c.data_ptr() == h.data_ptr() + 4 * rows * hidden


def test_lstm_cell_fn_backward_through_the_shared_buffer(monkeypatch):
    """``LSTMCellFn`` saves ``act`` and ``next_c`` as views of one buffer
    (as the CUDA wrapper returns them): its backward equals the plain
    version's VJP, also where the next step consumes both outputs."""
    rng = np.random.default_rng(31)
    n, h = 5, 6
    i2h, h2h = (rng.standard_normal((n, 4 * h)) * 2 for _ in range(2))
    c0 = rng.standard_normal((n, h))
    w = rng.standard_normal((h, 4 * h)) * 0.5
    arrays = [torch.from_numpy(a.astype(np.float32))
              for a in (i2h, h2h, c0, w)]
    plain = lstm_mod.lstm_cell

    def shared(i2h, h2h, c_prev, forget_bias=0.0, save=True):
        outs = lstm_mod.cell_outputs(i2h, *c_prev.shape, save)
        for buf, v in zip(outs, plain(i2h, h2h, c_prev, forget_bias, save)):
            if buf is not None:
                buf.copy_(v)
        return outs

    def two_steps(cell_fn):
        ins = [t.clone().requires_grad_(True) for t in arrays[:3]]
        h1, c1 = cell_fn(ins[0], ins[1], ins[2])
        h2, c2 = cell_fn(ins[0], h1 @ arrays[3], c1)
        (h2.sum() + (c2 * c2).sum() + 0.5 * h1.sum()).backward()
        return [t.grad for t in ins]

    want = two_steps(lambda a, b, c: lstm_mod.lstm_cell_plain(a, b, c,
                                                              1.0)[:2])
    monkeypatch.setattr(lstm_mod, "lstm_cell", shared)
    got = two_steps(lambda a, b, c: lstm_mod.LSTMCellFn.apply(a, b, c, 1.0))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **LSTM_TOL)


# -- bn_act_bwd_plain at the border shapes against the JAX package -----------
BORDER_SHAPES = [(1, 3, T + 1), (2, 3, 7, 7), (4, 5, 4, 4), (1, 3, 5, 5),
                 (3, 7, 1, 1)]


def _jax_grads(x, gamma, beta, mm, mv, head, eps, fix_gamma, global_stats,
               slope):
    bn = jreg.get("BatchNorm")
    params = bn.parse_params({"eps": eps, "momentum": 0.9,
                              "fix_gamma": fix_gamma,
                              "use_global_stats": global_stats})
    if slope is None:
        act = None
    elif slope:
        act = (jreg.get("LeakyReLU"), {"act_type": "leaky", "slope": slope})
    else:
        act = (jreg.get("Activation"), {"act_type": "relu"})
    mode = JOpMode(is_train=True)

    def fn(x, gamma, beta):
        outs, _aux = bn.apply([x, gamma, beta, jnp.asarray(mm),
                               jnp.asarray(mv)], params, mode)
        y = outs[0]
        if act is not None:
            op, raw = act
            y = op.apply([y], op.parse_params(raw), mode)[0][0]
        return y

    _out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, gamma, beta)))
    return [np.asarray(g) for g in vjp(jnp.asarray(head))]


@pytest.mark.parametrize("shape", BORDER_SHAPES)
@pytest.mark.parametrize("slope", [None, 0.0, 0.2])
@pytest.mark.parametrize("fix_gamma, global_stats", [(False, False),
                                                     (True, False),
                                                     (False, True)])
def test_bn_act_bwd_plain_matches_jax_at_the_borders(shape, slope, fix_gamma,
                                                     global_stats):
    rng = np.random.default_rng(sum(shape) + 7)
    c = shape[1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    x.reshape(-1)[::7] = 0.3  # pre-activations near and at 0
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    mm = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    mv = rng.uniform(0.5, 2.0, c).astype(np.float32)
    head = rng.standard_normal(shape).astype(np.float32)
    eps = 2e-5
    want = _jax_grads(x, gamma, beta, mm, mv, head, eps, fix_gamma,
                      global_stats, slope)
    tx = torch.from_numpy(x)
    if global_stats:
        mean, var, kvar = torch.from_numpy(mm), torch.from_numpy(mv), None
    else:
        mean, var, kvar = stats_mod.bn_stats_plain(
            tx, torch.from_numpy(mm.copy()), torch.from_numpy(mv.copy()),
            0.9)
    g = torch.ones(c) if fix_gamma else torch.from_numpy(gamma)
    inv = torch.rsqrt(var + eps).reshape((1, -1) + (1,) * (len(shape) - 2))
    t = (tx - mean.reshape(inv.shape)) * inv * g.reshape(inv.shape) + \
        torch.from_numpy(beta).reshape(inv.shape)
    y = None if slope is None else torch.where(t > 0, t, slope * t)
    before = bwd_mod.LAUNCHES.value
    got = bwd_mod.bn_act_bwd(torch.from_numpy(head), y, tx, mean, var,
                             torch.from_numpy(gamma), kvar, eps, fix_gamma,
                             slope)
    assert bwd_mod.LAUNCHES.value == before  # the plain version
    m = math.prod(shape) // c
    np.testing.assert_allclose(got[0].numpy(), want[0], **DX_TOL)
    for gg, ww in zip(got[1:], want[1:]):
        np.testing.assert_allclose(gg.numpy(), ww, rtol=1e-4,
                                   atol=m * 2.0 ** -24)
    if fix_gamma:
        assert not got[1].any()
