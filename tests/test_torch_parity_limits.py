"""The card-against-CPU training parity of ``chip_smoke.py`` can see a
fault in the BatchNorm backward.

``chip_smoke.py`` compares one fused training step of ResNet-50 on the card
with the port's CPU path, each kind of state in norm over all its tensors
(``PARITY_TOL``). Its limits on the momenta leave room for the card's other
summation order. Here the same comparison (its own ``parity_side``,
``parity_step`` and ``parity_diff``) holds a correct CPU step of a narrow
ResNet against one whose BatchNorm backward has a term dropped, and each
fault must land beyond the limit of the kind that should show it: a
dropped term of ``dx`` moves the momenta of every layer below it, a wrong
``dgamma`` or ``dbeta`` moves only the BatchNorm gamma/beta group. Run with
``-s`` to see each fault's readings.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.kernels import bn_act_bwd as bwd_mod
from mxnet_tpu_torch.models.resnet import resnet as torch_resnet

NARROW = dict(units=[1, 1, 1, 1], num_stages=4,
              filter_list=[8, 16, 32, 64, 128], image_shape=(3, 40, 40),
              num_classes=10)
BATCH = 8
# the kind of state that must show each fault
FAULTS = {"mean_term": "momentum", "var_term": "momentum",
          "dgamma": "bn_momentum", "dbeta": "bn_momentum"}


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    """(chip_smoke module, symbol, numpy args, auxs, images, labels, the
    correct step's readings)."""
    cs = _chip_smoke()
    with pmx.NameManager():
        sym = torch_resnet(**NARROW)
    shape = (BATCH,) + NARROW["image_shape"]
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    rng = np.random.default_rng(0)
    args = {}
    for name, s in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            std = math.sqrt(2.0 / math.prod(s[1:]))
            args[name] = rng.standard_normal(s, np.float32) * std
        elif name.endswith("_gamma"):
            args[name] = np.ones(s, np.float32)
        else:
            args[name] = np.zeros(s, np.float32)
    auxs = {n: (np.ones if n.endswith("_var") else np.zeros)(s, np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    x = rng.standard_normal(shape, np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.float32)
    want = _step(cs, sym, args, auxs, x, y)
    return cs, sym, args, auxs, x, y, want


def _step(cs, sym, args, auxs, x, y):
    side = cs.parity_side(pmx, sym, args, auxs, pmx.cpu(), x.shape)
    return cs.parity_step(torch, side, x, y, 1)


def _faulty(fault):
    """``bn_act_bwd_plain`` with one fault put in."""
    plain = bwd_mod.bn_act_bwd_plain

    def bwd(dy, y, x, mean, var, gamma, kvar, eps, fix_gamma, relu):
        dx, dgamma, dbeta = plain(dy, y, x, mean, var, gamma, kvar, eps,
                                  fix_gamma, relu)
        axes = (0,) + tuple(range(2, x.dim()))
        bshape = (1, -1) + (1,) * (x.dim() - 2)
        n = float(math.prod(x.shape[i] for i in axes))
        d = torch.where(y > 0, dy, 0.0) if relu else dy
        inv = torch.rsqrt(var + eps)
        xhat = (x - mean.reshape(bshape)) * inv.reshape(bshape)
        scale = (inv if fix_gamma else gamma * inv).reshape(bshape)
        if fault == "mean_term" and kvar is not None:
            dx = dx + scale * (d.sum(dim=axes) / n).reshape(bshape)
        elif fault == "var_term" and kvar is not None:
            dx = dx + scale * xhat * (kvar * (d * xhat).sum(dim=axes)
                                      / n).reshape(bshape)
        elif fault == "dgamma" and not fix_gamma:
            dgamma = torch.zeros_like(dgamma)
        elif fault == "dbeta":
            dbeta = torch.zeros_like(dbeta)
        return dx, dgamma, dbeta
    return bwd


@pytest.mark.parametrize("fault", list(FAULTS))
def test_parity_limits_catch_bn_backward_fault(setup, fault, monkeypatch):
    cs, sym, args, auxs, x, y, want = setup
    monkeypatch.setattr(bwd_mod, "bn_act_bwd_plain", _faulty(fault))
    got = _step(cs, sym, args, auxs, x, y)
    readings = {kind: cs.parity_diff(got[kind], want[kind])[0]
                for kind in cs.PARITY_TOL}
    print(f"\n{fault}: " + ", ".join(f"{k} {v:.3g}"
                                     for k, v in readings.items()))
    kind = FAULTS[fault]
    assert readings[kind] > cs.PARITY_TOL[kind][0], readings
