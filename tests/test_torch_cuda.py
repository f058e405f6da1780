"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (a CUDA kernel has no CPU mode). The
file imports neither ``jax`` nor ``mxnet_tpu``, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are float32: rtol 1e-5 / atol 1e-6 for ``bn_act`` (rsqrt and
division may differ by an ulp), 1e-6 absolute for probabilities.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import bn_act as bn_mod
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
