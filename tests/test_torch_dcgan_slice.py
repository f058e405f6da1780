"""DCGAN trained by the PyTorch port's ``GANModule``, held against the JAX
package's at the sizes of ``tests/test_whole_zoo_fastpath.py``'s DCGAN
tests (``ngf = ndf = 4``, batch 4, z 8, 64x64 images), on the CPU.

Both packages start from the same weights (the JAX ``GANModule``'s
``get_params()`` carried across by ``convert.gan_params_from_numpy``) and
take two steps on the same real batches with the same pinned latents:
the port's ``train_window(latents=)`` and its ``_serial_window`` against
the JAX ``train_window(latents=)`` and ``_serial_window``. After the two
steps every G and D parameter, every BatchNorm statistic, both Adam
states of every parameter and the published real-pass outputs agree
within rtol 1e-4 / atol 1e-5 (float32 on both sides, contractions summed
in other orders; Adam's first steps move each weight by about +-lr
whatever the gradient's size, so a gradient that changed sign would show
as 2 * lr = 4e-4 and fail). Also: the symbols' JSON and shapes, the
executor routes in both networks, the generator's inference forward, the
window's contract (seeded latents, the latents check, ``WindowBoundary``)
and the example's ``CustomMetric`` loop.
"""

import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models as jmodels

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import gan_params_from_numpy

BS, Z, NF = 4, 8, 4
STEPS = 2
TOL = dict(rtol=1e-4, atol=1e-5)
CPU = pmx.cpu()


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    reals = [(rng.rand(BS, 3, 64, 64).astype(np.float32) * 2 - 1)
             for _ in range(STEPS)]
    lats = [rng.randn(BS, Z, 1, 1).astype(np.float32) for _ in range(STEPS)]
    return reals, lats


def _jax_gan():
    jmx.random.seed(7)
    gan = jmx.mod.GANModule(
        jmodels.dcgan_generator(ngf=NF, nc=3),
        jmodels.dcgan_discriminator(ndf=NF), context=jmx.cpu(),
        batch_size=BS, code_shape=(Z, 1, 1), data_shape=(3, 64, 64))
    gan.bind()
    gan.init_params()
    gan.init_optimizer()
    return gan


def _numpy_params(mod):
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _port_gan(init):
    gan = pmx.mod.GANModule(
        pmx.models.dcgan_generator(ngf=NF, nc=3),
        pmx.models.dcgan_discriminator(ndf=NF), context=CPU,
        batch_size=BS, code_shape=(Z, 1, 1), data_shape=(3, 64, 64))
    gan.bind()
    gan.init_params()
    gan.init_optimizer()
    gan_params_from_numpy(gan, *init)
    return gan


def _state(gan):
    """Parameters, BatchNorm statistics and Adam states as numpy."""
    st = {}
    for tag, mod in (("g", gan.mod_g), ("d", gan.mod_d)):
        arg, aux = mod.get_params()
        for n, v in arg.items():
            st[f"{tag}.{n}"] = v.asnumpy()
        for n, v in aux.items():
            st[f"{tag}.aux.{n}"] = v.asnumpy()
        names = mod._exec_group.param_names
        for i, (mean, var) in mod._updater.states.items():
            st[f"{tag}.adam_mean.{names[i]}"] = mean.asnumpy()
            st[f"{tag}.adam_var.{names[i]}"] = var.asnumpy()
    return st


def _run(gan, method, reals, lats, pkg):
    kw = {"ctx": CPU} if pkg is pmx else {}
    batches = [pkg.nd.array(r, **kw) for r in reals]
    latents = [pkg.nd.array(z, **kw) for z in lats]
    if method == "window":
        b = gan.train_window(None, batches=batches, latents=latents)
    else:
        b = gan._serial_window(batches, latents)
    return _state(gan), [o.asnumpy() for o in b.outputs]


@pytest.fixture(scope="module")
def reference():
    """The JAX package's two steps by both of its methods, from one
    initialization, and that initialization as numpy."""
    reals, lats = _inputs()
    init = None
    out = {}
    for method in ("window", "serial"):
        gan = _jax_gan()
        if init is None:
            init = (_numpy_params(gan.mod_g), _numpy_params(gan.mod_d))
        out[method] = _run(gan, method, reals, lats, jmx)
    return init, out


@pytest.mark.parametrize("ref_method", ["window", "serial"])
@pytest.mark.parametrize("method", ["window", "serial"])
def test_two_gan_steps_match_reference(reference, method, ref_method):
    init, ref = reference
    reals, lats = _inputs()
    got_state, got_outs = _run(_port_gan(init), method, reals, lats, pmx)
    want_state, want_outs = ref[ref_method]
    assert got_state.keys() == want_state.keys()
    for key, want in want_state.items():
        np.testing.assert_allclose(got_state[key], want, err_msg=key, **TOL)
    assert len(got_outs) == len(want_outs) == 1
    assert got_outs[0].shape == (BS, 1)
    np.testing.assert_allclose(got_outs[0], want_outs[0], **TOL)


def test_gan_steps_moved_every_state(reference):
    """The comparison above is not empty: the steps changed every kind."""
    init, ref = reference
    state, _outs = ref["window"]
    for tag, (arg, aux) in zip("gd", init):
        for n, v in list(arg.items()) + list(aux.items()):
            key = f"{tag}.{n}" if n in arg else f"{tag}.aux.{n}"
            if n.endswith("_gamma"):  # fix_gamma: the gamma stays 1
                continue
            assert not np.array_equal(state[key], v), key


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_dcgan_symbols_match_reference(which):
    shapes = {"generator": {"rand": (BS, Z, 1, 1)},
              "discriminator": {"data": (BS, 3, 64, 64), "label": (BS,)}}
    syms = []
    for pkg, models in ((jmx, jmodels), (pmx, pmx.models)):
        with pkg.name.NameManager():
            build = getattr(models, f"dcgan_{which}")
            syms.append(build(ngf=NF, nc=3) if which == "generator"
                        else build(ndf=NF))
    jsym, psym = syms
    assert json.loads(psym.tojson()) == json.loads(jsym.tojson())
    assert psym.infer_shape(**shapes[which]) == \
        tuple(jsym.infer_shape(**shapes[which]))


def test_routes_fire_in_both_networks(reference):
    gan = _port_gan(reference[0])
    g_fused = gan.mod_g._exec_group._exec.graph.fused
    d_fused = gan.mod_d._exec_group._exec.graph.fused
    assert sorted(s for _bn, s in g_fused.values()) == [0.0] * 4
    assert sorted(s for _bn, s in d_fused.values()) == [0.2] * 3
    # dact1 follows a convolution: no BatchNorm to fuse it into
    assert {bn.name for bn, _s in d_fused.values()} == {"dbn2", "dbn3",
                                                        "dbn4"}


def test_generator_inference_matches_reference(reference):
    """``Module(g_sym).forward(is_train=False)``: the generation leg."""
    init = reference[0][0]
    z = np.random.RandomState(5).randn(BS, Z, 1, 1).astype(np.float32)
    outs = []
    for pkg, models in ((jmx, jmodels), (pmx, pmx.models)):
        kw = {"ctx": CPU} if pkg is pmx else {}
        mod = pkg.mod.Module(models.dcgan_generator(ngf=NF, nc=3),
                             data_names=("rand",), label_names=None,
                             context=pkg.cpu())
        mod.bind(data_shapes=[pkg.io.DataDesc("rand", (BS, Z, 1, 1))],
                 for_training=False)
        mod.init_params(arg_params={k: pkg.nd.array(v, **kw)
                                    for k, v in init[0].items()},
                        aux_params={k: pkg.nd.array(v, **kw)
                                    for k, v in init[1].items()})
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(z, **kw)], label=[]),
                    is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    assert outs[1].shape == (BS, 3, 64, 64)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_window_latents_are_seeded(reference):
    """Without ``latents`` the window draws from the port's seeded
    generator: the same seed gives the same steps, and the serial loop's
    ``nd.random_normal`` draws the same noise."""
    reals, _lats = _inputs()
    states = []
    for method in ("window", "window", "serial"):
        pmx.random.seed(21)
        gan = _port_gan(reference[0])
        batches = [pmx.nd.array(r, ctx=CPU) for r in reals]
        if method == "window":
            gan.train_window(None, batches=batches)
        else:
            gan._serial_window(batches, None)
        states.append(_state(gan))
    for key in states[0]:
        np.testing.assert_array_equal(states[1][key], states[0][key])
        np.testing.assert_allclose(states[2][key], states[0][key], rtol=0,
                                   atol=1e-7)


def test_window_contract(reference):
    gan = _port_gan(reference[0])
    reals, lats = _inputs()
    real = pmx.nd.array(reals[0], ctx=CPU)
    assert gan.train_window(None, batches=[]) is None
    with pytest.raises(MXNetError, match="latents"):
        gan.train_window(real, n_steps=2, latents=[lats[0]])
    # one stacked draw for one step; a DataBatch as the real batch
    b = gan.train_window(pmx.io.DataBatch([real], None), latents=lats[0])
    assert b.n_steps == 1 and b.wait() is b
    assert [o.shape for o in b.outputs] == [(BS, 1)]
    # n_steps with one real batch, stacked latents
    b = gan.train_window(real, n_steps=2, latents=np.stack(lats))
    assert b.n_steps == 2


def facc(label, pred):
    pred = pred.ravel()
    label = label.ravel()
    return ((pred > 0.5) == label).mean()


def test_example_metric_loop(reference):
    """``examples/train_dcgan.py``'s loop: windows of 2 over 4 batches,
    the metric read from each boundary's real-pass outputs."""
    pmx.random.seed(0)
    gan = _port_gan(reference[0])
    rs = np.random.RandomState(0)
    reals = [pmx.nd.array(rs.rand(BS, 3, 64, 64).astype(np.float32) * 2 - 1,
                          ctx=CPU) for _ in range(4)]
    metric = pmx.metric.CustomMetric(facc)
    ones = pmx.nd.ones((BS,), ctx=CPU)
    for i in range(0, len(reals), 2):
        boundary = gan.train_window(None, batches=reals[i:i + 2])
        metric.update([ones], boundary.outputs)
    name, acc = metric.get()
    assert name == "facc" and 0.0 <= acc <= 1.0
    assert metric.num_inst == 2
