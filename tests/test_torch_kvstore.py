"""The port's in-process KVStore held against the JAX package's, on the CPU.

``init``/``push``/``pull`` of a single value and of a list of 3 per-device
values (summed), without an updater (the merged value is stored) and with
SGD-momentum set by ``set_optimizer`` (applied to the stored weight), then
``save_optimizer_states``/``load_optimizer_states`` into a fresh store:
values within 1e-6 of the reference's (float32, the same operations in the
same order), momenta equal after the save and the load, and a state file
written by either package loads in the other. ``create``'s accepted
names, the ``dist`` ones refused with ``MXNetError`` naming item 7 and
unknown ones with ``ValueError`` as the reference's; ``_create_kvstore``'s
four cases. ``Module.fit(kvstore=mx.kv.create("device"))`` on an MLP for 3
steps from the same weights against the reference's: the store owns the
update (``update_on_kvstore``), each step takes one fused update, the
parameters agree within 1e-5 and ``kv.pull`` returns the module's weights;
the module's optimizer states save and load through the store, and a
``BucketingModule`` shares its store with every bucket.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import model as jmodel

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import model as pmodel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import sgd_mom_multi as sgd_mod

CPU = pmx.cpu()
SHAPES = [(3, 4), (5,), (2, 2, 3)]
OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5)


def _arrays(pkg, values):
    if pkg is pmx:
        return [pmx.nd.array(v, ctx=CPU) for v in values]
    return [jmx.nd.array(v) for v in values]


def _drive(pkg, optimizer, seed=0):
    """Init 3 keys, push a single value to key 0 and lists of 3 to keys 1
    and 2, twice, pulling after each round. Returns the pulled values and
    the store."""
    rng = np.random.default_rng(seed)
    kv = pkg.kv.create("device")
    inits = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    kv.init([0, 1, 2], _arrays(pkg, inits))
    if optimizer:
        kv.set_optimizer(pkg.optimizer.create("sgd", **OPT))
    pulled = []
    for _ in range(2):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        parts = [[g * f for f in (0.5, 0.25, 0.25)] for g in grads[1:]]
        kv.push(0, _arrays(pkg, [grads[0]])[0])
        kv.push([1, 2], [_arrays(pkg, p) for p in parts])
        outs = _arrays(pkg, [np.zeros(s, np.float32) for s in SHAPES])
        kv.pull([0, 1, 2], out=outs)
        pulled.append([o.asnumpy() for o in outs])
    return pulled, kv


@pytest.mark.parametrize("optimizer", [False, True])
def test_push_pull_match_reference(optimizer):
    want, _ = _drive(jmx, optimizer)
    got, kv = _drive(pmx, optimizer)
    for g_round, w_round in zip(got, want):
        for g, w in zip(g_round, w_round):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert kv.type == "device" and kv.rank == 0 and kv.num_workers == 1
    assert kv.broadcast_ints([3, 4]) == [3, 4]
    kv.barrier()


def test_values_stay_on_the_device_of_init():
    kv = pmx.kv.create("local")
    v = pmx.nd.array(np.ones((2, 2), np.float32), ctx=CPU)
    kv.init("w", v)
    assert kv._store["w"].context == CPU
    assert kv._store["w"]._data.data_ptr() != v._data.data_ptr()
    with pytest.raises(MXNetError, match="already initialized"):
        kv.init("w", v)
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push("x", v)
    with pytest.raises(MXNetError, match="item 13"):
        kv.row_sparse_pull("w", out=v, row_ids=v)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_optimizer_states_save_and_load(tmp_path, writer):
    """Momenta after two updating rounds, saved by one package and loaded
    into a fresh store of the other (and of the port), are the same."""
    pkgs = {"jax": jmx, "port": pmx}
    _, src = _drive(pkgs[writer], True)
    fname = str(tmp_path / "kv.states")
    src.save_optimizer_states(fname)
    momenta = {k: np.array(v.asnumpy())
               for k, v in src._updater.states.items()}
    assert sorted(momenta) == [0, 1, 2]
    for pkg in (jmx, pmx):
        kv = pkg.kv.create("local")
        kv.set_optimizer(pkg.optimizer.create("sgd", **OPT))
        with pmx.cpu():
            kv.load_optimizer_states(fname)
        for k, m in momenta.items():
            np.testing.assert_array_equal(kv._updater.states[k].asnumpy(), m)
    with pytest.raises(MXNetError, match="no optimizer"):
        pmx.kv.create().save_optimizer_states(fname)


@pytest.mark.parametrize("name", [
    "local", "LOCAL", "device", "nccl", "local_update_cpu",
    "local_allreduce_cpu", "local_allreduce_device"])
def test_create_accepts_the_local_types(name):
    kv, want = pmx.kv.create(name), jmx.kv.create(name)
    assert isinstance(kv, pmx.kvstore.KVStore)
    assert kv.type == want.type == name.lower()
    assert pmx.kvstore is pmx.kv


@pytest.mark.parametrize("name", ["dist", "dist_sync", "dist_device_sync",
                                  "dist_async", "dist_sync_device",
                                  "dist_device_async"])
def test_create_refuses_dist_types(name):
    with pytest.raises(MXNetError, match="queue 1 item 7"):
        pmx.kv.create(name)


@pytest.mark.parametrize("name", ["sharded", "", 3])
def test_create_refuses_unknown_names_as_reference(name):
    with pytest.raises(Exception) as want:
        jmx.kv.create(name)
    with pytest.raises(want.type) as got:
        pmx.kv.create(name)
    assert str(got.value) == str(want.value)


def test_create_kvstore_cases():
    small = {"w": pmx.nd.zeros((4, 4), ctx=CPU)}
    big = {"w": pmx.nd.zeros((4097, 4097), ctx=CPU)}  # past 16 M elements
    kv = pmx.kv.create("device")
    for pkg_model, store, args in ((pmodel, kv, small),
                                   (jmodel, jmx.kv.create("device"),
                                    {"w": jmx.nd.zeros((4, 4))})):
        assert pkg_model._create_kvstore(None, 1, args) == (None, False)
        assert pkg_model._create_kvstore(store, 1, args) == (store, True)
        assert pkg_model._create_kvstore("local", 1, args) == (None, False)
    got, on_kv = pmodel._create_kvstore("local", 2, small)
    assert isinstance(got, pmx.kvstore.KVStore) and on_kv
    got, on_kv = pmodel._create_kvstore("local", 2, big)
    assert isinstance(got, pmx.kvstore.KVStore) and not on_kv
    with pytest.raises(MXNetError, match="item 7"):
        pmodel._create_kvstore("dist_sync", 1, small)
    with pytest.raises(TypeError):
        pmodel._create_kvstore(3, 1, small)


# --- Module.fit through a store ---------------------------------------------

def _mlp(pkg):
    with (jmx.name.NameManager() if pkg is jmx else pmx.NameManager()):
        data = pkg.sym.Variable("data")
        fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
        act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
        fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name="fc2")
        return pkg.sym.SoftmaxOutput(fc2, name="softmax")


@pytest.fixture(scope="module")
def mlp_data():
    rng = np.random.default_rng(3)
    args = {"fc1_weight": rng.standard_normal((16, 8)) * 0.3,
            "fc1_bias": rng.uniform(-0.1, 0.1, 16),
            "fc2_weight": rng.standard_normal((4, 16)) * 0.3,
            "fc2_bias": rng.uniform(-0.1, 0.1, 4)}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    x = rng.standard_normal((12, 8)).astype(np.float32)
    y = rng.integers(0, 4, 12).astype(np.float32)
    return args, x, y


def _fit(pkg, mlp_data, kv):
    args, x, y = mlp_data
    ctx = CPU if pkg is pmx else jmx.cpu()
    kw = {"ctx": CPU} if pkg is pmx else {}
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    it = pkg.io.NDArrayIter(x, y, batch_size=4, **kw)
    arg_nd = {k: (pmx.nd.array(v, ctx=CPU) if pkg is pmx
                  else jmx.nd.array(v)) for k, v in args.items()}
    mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
            optimizer_params=dict(learning_rate=0.1, momentum=0.9, wd=1e-4),
            arg_params=arg_nd)
    return mod


def test_module_fit_through_a_store_matches_reference(mlp_data, tmp_path):
    jmod = _fit(jmx, mlp_data, jmx.kv.create("device"))
    kv = pmx.kv.create("device")
    pmod = _fit(pmx, mlp_data, kv)
    assert pmod._update_on_kvstore and pmod._kvstore is kv
    assert pmod._updater is None and kv._updater is not None
    got, _ = pmod.get_params()
    want, _ = jmod.get_params()
    for n in want:
        np.testing.assert_allclose(got[n].asnumpy(), want[n].asnumpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    # the store holds the trained weights, sharing the executor's tensors
    exe = pmod._exec_group._exec
    for i, n in enumerate(pmod._exec_group.param_names):
        out = pmx.nd.zeros(got[n].shape, ctx=CPU)
        kv.pull(i, out=out)
        np.testing.assert_array_equal(out.asnumpy(), got[n].asnumpy())
        assert kv._store[str(i)]._data is exe.arg_dict[n]._data
    # the optimizer states go through the store: 4 momenta, and a load
    # puts them back after they were cleared
    fname = str(tmp_path / "mod.states")
    pmod.save_optimizer_states(fname)
    moms = {k: v.asnumpy() for k, v in kv._updater.states.items()}
    assert sorted(moms) == [0, 1, 2, 3]
    kv._updater.states = {}
    with pmx.cpu():
        pmod.load_optimizer_states(fname)
    for k, m in moms.items():
        np.testing.assert_array_equal(kv._updater.states[k].asnumpy(), m)
    jname = str(tmp_path / "jax.states")
    jmod.save_optimizer_states(jname)
    kv._updater.states = {}
    with pmx.cpu():
        pmod.load_optimizer_states(jname)
    for k, m in moms.items():
        np.testing.assert_allclose(kv._updater.states[k].asnumpy(), m,
                                   rtol=1e-5, atol=1e-5)


def test_store_update_takes_one_fused_launch_a_step(mlp_data, monkeypatch):
    """Each step of the store's path runs the fused update once (on the CPU
    its plain version: the wrapper's packing counter stays at 0 and its
    launch counter too), never the per-parameter push/pull."""
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    kv = pmx.kv.create("local")
    pushes = pmx.telemetry.counter("kvstore.push")
    before = (pushes.value, sgd_mod.LAUNCHES.value)
    calls = []
    apply = pmx.optimizer.SGD.torch_apply
    monkeypatch.setattr(pmx.optimizer.SGD, "torch_apply",
                        lambda self, *a, **k: calls.append(1) or
                        apply(self, *a, **k))
    _fit(pmx, mlp_data, kv)
    assert len(calls) == 3
    assert (pushes.value, sgd_mod.LAUNCHES.value) == before


def test_imperative_update_goes_through_push_and_pull(mlp_data,
                                                      monkeypatch):
    """With the fused update off (``MXNET_EXEC_BULK_EXEC_TRAIN=0``), each
    parameter is pushed (the store applies SGD) and pulled back, as the
    reference does."""
    monkeypatch.setenv("MXNET_EXEC_BULK_EXEC_TRAIN", "0")
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    pushes = pmx.telemetry.counter("kvstore.push")
    before = pushes.value
    jmod = _fit(jmx, mlp_data, jmx.kv.create("local"))
    pmod = _fit(pmx, mlp_data, pmx.kv.create("local"))
    assert pushes.value == before + 3 * 4
    got, want = pmod.get_params()[0], jmod.get_params()[0]
    for n in want:
        np.testing.assert_allclose(got[n].asnumpy(), want[n].asnumpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


def test_bucketing_module_shares_the_store():
    sym = _mlp(pmx)
    mod = pmx.mod.BucketingModule(lambda key: (sym, ("data",),
                                               ("softmax_label",)),
                                  default_bucket_key=8, context=CPU)
    mod.bind([("data", (4, 8))], [("softmax_label", (4,))])
    mod.init_params()
    kv = pmx.kv.create("device")
    mod.init_optimizer(kvstore=kv)
    mod.switch_bucket(9, [("data", (4, 8))], [("softmax_label", (4,))])
    for m in mod._buckets.values():
        assert m._kvstore is kv and m._update_on_kvstore
